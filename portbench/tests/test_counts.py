"""The yardstick's arithmetic against hand-computed values: attention
bytes and FLOPs, the FLOP count behind ``mfu``, the trace reduction and
the readers, the traffic."""

from __future__ import annotations

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import tracing, traffic
from portbench.common import ROOT, metric_reader
from portbench.metrics import attention_roofline
from portbench.reference.stackgan import Reference

PEAKS = {"bf16_flops": 989.4e12, "hbm_bytes_per_s": 3.35e12}
BERT = {"num_heads": 2, "dropout_rate": 0.1, "layer_norm_eps": 1e-12, "num_layers": 1}


def test_attention_least_time_by_hand():
    # 2 rows of T = 4, hidden 16, keys 3 and 4 long, with a backward, bf16
    call = {"lengths": [3, 4], "seq": 4, "hidden": 16, "heads": 2, "backward": True, "element_bytes": 2}
    pairs = 4 * 3 + 4 * 4  # every query row against its row's unmasked keys
    flops = 12 * 16 * pairs  # 4 d a pair and head forward, 8 d backward, over 2 heads of 8
    nbytes = 8 * 2 * 4 * 16 * 2  # q k v o dO dq dk dv, each once
    assert attention_roofline.least_seconds(call, PEAKS) == max(nbytes / 3.35e12, flops / 989.4e12)
    fwd = dict(call, backward=False)
    assert attention_roofline.least_seconds(fwd, PEAKS) == max(4 * 2 * 4 * 16 * 2 / 3.35e12, 4 * 16 * pairs / 989.4e12)


def test_attention_roofline_reader():
    call = {"lengths": [128] * 4, "seq": 128, "hidden": 768, "heads": 12, "backward": True, "element_bytes": 2}
    least = attention_roofline.least_seconds(call, PEAKS)
    rank = {"kernels": {"attention_fwd_wgmma_kernel<64, 2>": [1, least], "attention_bwd_dq_wgmma_kernel": [1, least],
                        "other_kernel": [3, 5.0]}, "work": {"attention": [call]}, "steps": 1}
    assert attention_roofline.read({"trace": rank, "peaks": PEAKS}) == pytest.approx(50.0)
    assert attention_roofline.read({"trace": dict(rank, kernels={}), "peaks": PEAKS}) is None


def test_reference_flops_by_hand():
    """FlopCounterMode over the reference's dense layer and attention: 2 B
    in out for a product, 4 B T^2 H for the attention's two."""
    ref = Reference({"bert": BERT}, 1, torch.float32)
    P = {"d.weight": torch.zeros(8, 16), "d.bias": torch.zeros(8)}
    with FlopCounterMode(display=False) as c:
        ref.dense(P, "d", torch.zeros(5, 16))
    assert c.get_total_flops() == 2 * 5 * 16 * 8
    q = torch.zeros(3, 4, 16)
    with FlopCounterMode(display=False) as c:
        ref.attention(q, q, q, torch.ones(3, 4, dtype=torch.int32), 0.0, 0)
    assert c.get_total_flops() == 4 * 3 * 4 * 4 * 16


def test_mfu_reader():
    ctx = {"peaks": PEAKS, "flops_per_step": 2e12, "window": {"steps": 30, "seconds": 10.0}}
    assert metric_reader("mfu.train").read(ctx) == pytest.approx(100 * 2e12 * 3 / 989.4e12)
    assert metric_reader("mfu.train").read(dict(ctx, peaks={})) is None


def _event(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_trace_reduction():
    events = [
        _event("aten::conv", "cpu_op", 0, 30),
        _event("aten::add", "cpu_op", 40, 50),
        _event("sm90_xmma_fprop_kernel", "kernel", 10, 20),  # busy 10-30
        _event("ncclDevKernel_AllReduce", "kernel", 25, 10),  # overlaps: busy to 35
        _event("Memcpy HtoD", "gpu_memcpy", 60, 10),  # busy 60-70
        _event("late_kernel", "kernel", 95, 5),  # busy 95-100
    ]
    r = tracing.reduce_trace(events, steps=2, window_s=100e-6)
    assert r["window_s"] == pytest.approx(100e-6) and r["busy_s"] == pytest.approx(40e-6)
    assert set(r["kernels"]) == {"sm90_xmma_fprop_kernel", "ncclDevKernel_AllReduce", "late_kernel"}
    # idle 35-60 (middle 47.5: aten::add, started at 40, runs), 70-95 (middle 82.5: aten::add)
    assert r["gaps"] == {"aten::add": pytest.approx(50e-6)}
    assert tracing.reduce_trace(events[2:], steps=2, window_s=100e-6)["gaps"] == {}
    # the measured window: 4 steps in 200 us, 50 us a step, of which the
    # trace's 20 us a step were busy
    ctx = {"trace": r, "window": {"steps": 4, "seconds": 200e-6}}
    assert metric_reader("device_idle_pct.train").read(ctx) == pytest.approx(60.0)
    assert metric_reader("launches_per_step.train").read(ctx) == pytest.approx(1.5)
    assert metric_reader("conv_ms.train").read(ctx) == pytest.approx(1e3 * 20e-6 / 2)
    assert metric_reader("layout_copy_ms.train").read(ctx) is None
    b = tracing.breakdown(r)
    assert b["device_ops"][0] == ["sm90_xmma_fprop_kernel", pytest.approx(20e-6)]
    assert b["idle_gaps"] == [["aten::add", pytest.approx(50e-6)]]


def test_kernel_classes_frozen_copy():
    table = json.loads((ROOT / "kernel_classes.json").read_text())["classes"]
    assert table[0][0] == "hand kernels"
    assert tracing.kernel_class("void cudnn::nchwToNhwcKernel<float>", table) == "copies and layout transforms"
    assert tracing.kernel_class("sm80_xmma_fprop_implicit_gemm_bf16", table) == "cuDNN convolutions"
    assert tracing.kernel_class("attention_fwd_wgmma_kernel", table) == "hand kernels"
    assert tracing.kernel_class("something_new", table) == "other"


def test_traffic_is_seeded_and_the_same_work_for_every_seed():
    mix = json.loads((ROOT / "traffic" / "short_captions_b256.json").read_text())
    seed = 2**33 + 12345  # wider than 32 bits, as a run's seed may be
    a = traffic.batch(mix, seed, 0, 0, 128, 28996, 64, "cpu")
    b = traffic.batch(mix, seed, 0, 0, 128, 28996, 64, "cpu")
    c = traffic.batch(mix, seed + 1, 0, 0, 128, 28996, 64, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["input_ids"], c["input_ids"])
    la, lc = a["attention_mask"].sum(1), c["attention_mask"].sum(1)
    assert sorted(la.tolist()) == sorted(lc.tolist()) and not torch.equal(la, lc)
    assert la.float().mean().item() == pytest.approx(traffic.mean_length(mix["captions"]["length_histogram"]), abs=0.6)
    ids = a["input_ids"]
    assert (ids[:, 0] == 101).all() and a["image"].dtype == torch.uint8 and a["image"].shape == (256, 64, 64, 3)
    rows = torch.arange(256)
    assert (ids[rows, la - 1] == 102).all() and (ids[a["attention_mask"] == 0] == 0).all()
    other_rank = traffic.batch(mix, seed, 1, 0, 128, 28996, 64, "cpu")
    assert not torch.equal(a["input_ids"], other_rank["input_ids"])
