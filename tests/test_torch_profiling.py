"""The port's profiling hooks (``utils/profiling.py``) on the CPU: ``trace``
writes one Chrome trace per rank with the block's operators in it, and
nothing when the block raises; ``span`` names a phase in a profiler's
trace and builds nothing without one; both stages' training steps show
their phases as spans, and stage 1's gradient split at the text
embedding is the one call's. The CLIs' ``--profile_dir`` runs are in
``tests/test_torch_train_cli.py`` and ``tests/test_torch_generate_cli.py``."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from imagegenerator_tpu_torch.train import stage1 as ts1
from imagegenerator_tpu_torch.train import stage2 as ts2
from imagegenerator_tpu_torch.utils import profiling


def test_trace_writes_one_file_per_rank(tmp_path, capsys):
    logdir = tmp_path / "prof"
    with profiling.trace(str(logdir)):
        torch.nn.functional.conv2d(torch.randn(1, 3, 8, 8), torch.randn(4, 3, 3, 3)).sum()
    assert sorted(p.name for p in logdir.iterdir()) == ["trace_rank0.json"]
    assert profiling.trace_path(str(logdir)) == str(logdir / "trace_rank0.json")
    assert profiling.trace_path("d", rank=3).endswith("trace_rank3.json")
    events = json.loads((logdir / "trace_rank0.json").read_text())["traceEvents"]
    assert any(e.get("name") == "aten::conv2d" for e in events)
    assert "[profile] trace written to" in capsys.readouterr().out
    with pytest.raises(ValueError):
        with profiling.trace(str(tmp_path / "failed")):
            raise ValueError("the block failed")
    assert not (tmp_path / "failed" / "trace_rank0.json").exists()


def _annotations(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def test_span_writes_a_user_annotation(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("phase"):
            torch.ones(3) + 1
    events = _annotations(prof, tmp_path)
    found = [e for e in events if e.get("name") == "phase"]
    assert [e["cat"] for e in found] == ["user_annotation"]
    add = next(e for e in events if e.get("name") == "aten::add")
    assert found[0]["ts"] <= add["ts"] and add["ts"] + add["dur"] <= found[0]["ts"] + found[0]["dur"]


def test_span_without_a_profiler_builds_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with profiling.span("phase"):
        pass


def _system(stage, **kw):
    """A tiny system of ``stage`` on the CPU with a batch of 4 and the
    step's keyword arguments."""
    gen = torch.Generator().manual_seed(0)
    cfg = (ts1.Stage1Config if stage == 1 else ts2.Stage2Config).tiny(**kw)
    system = (ts1.Stage1System if stage == 1 else ts2.Stage2System)(cfg, device="cpu", generator=gen)
    T, r, B = cfg.seq_len, cfg.resolution, 4
    batch = {"input_ids": torch.randint(1, cfg.bert.vocab_size, (B, T), generator=gen),
             "attention_mask": torch.ones(B, T, dtype=torch.int32),
             "image": torch.randint(0, 256, (B, r, r, 3), generator=gen, dtype=torch.uint8)}
    batch["attention_mask"][1, T // 2:] = 0
    step_kw = dict(generator=torch.Generator().manual_seed(1))
    if stage == 1:
        step_kw["host_generator"] = torch.Generator().manual_seed(2)
    return system, batch, step_kw


PHASES = {"data", "train_step", "text", "critic", "generator", "text_backward", "optimizer"}


def _inside(inner, outer):
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


@pytest.mark.parametrize("stage", [1, 2])
def test_train_step_spans(stage, tmp_path):
    """One step under the profiler: ``train_step`` once around ``text``,
    ``n_critic`` ``critic`` spans that each hold their critic update,
    ``generator`` after them, then (stage 1) ``text_backward`` holding
    the encoder's backward and no convolution's, then the generator
    side's updates."""
    system, batch, step_kw = _system(stage)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        system.train_step(batch, **step_kw)
    events = [e for e in _annotations(prof, tmp_path) if e.get("ph") == "X"]
    spans = {}
    for e in events:  # the optimizers' own annotations ("Optimizer.step#Adam.step") aside
        if e.get("cat") == "user_annotation" and e["name"] in PHASES:
            spans.setdefault(e["name"], []).append(e)
    n_critic, gen_side = system.config.n_critic, (4 if stage == 1 else 2)
    names = PHASES - {"data"} - ({"text_backward"} if stage == 2 else set())
    assert set(spans) == names
    counts = {k: len(v) for k, v in spans.items()}
    assert counts == dict({k: 1 for k in names}, critic=n_critic, optimizer=n_critic + gen_side)
    (step,), (text,), (gen,) = spans["train_step"], spans["text"], spans["generator"]
    assert all(_inside(e, step) for v in spans.values() for e in v)
    critics = sorted(spans["critic"], key=lambda e: e["ts"])
    assert text["ts"] + text["dur"] <= critics[0]["ts"] and critics[-1]["ts"] + critics[-1]["dur"] <= gen["ts"]
    updates = sorted(spans["optimizer"], key=lambda e: e["ts"])
    assert all(_inside(u, c) for u, c in zip(updates, critics))
    last = gen
    if stage == 1:
        (back,) = spans["text_backward"]
        assert gen["ts"] + gen["dur"] <= back["ts"]
        ops = [e for e in events if e.get("cat") == "cpu_op"]
        embed_bwd = [e for e in ops if e["name"] == "aten::embedding_dense_backward"]
        assert embed_bwd and all(_inside(e, back) for e in embed_bwd)
        assert not any(_inside(e, back) for e in ops if e["name"] == "aten::convolution_backward")
        assert any(_inside(e, gen) for e in ops if e["name"] == "aten::convolution_backward")
        last = back
    assert all(last["ts"] + last["dur"] <= u["ts"] for u in updates[n_critic:])


@pytest.mark.parametrize("policy", [{}, {"text_reuse_mismatched": True}, {"text_resample_per_iter": True}])
def test_stage1_split_gradient_is_the_single_calls(policy, monkeypatch):
    """Stage 1 takes the generator side's gradient in two calls, split at
    the text embedding; each parameter's gradient is bit for bit that of
    one call over them all, on every text policy."""
    system, batch, step_kw = _system(1, n_critic=2, **policy)
    of = lambda *names: [p for n in names for p in getattr(system, n).parameters()]
    text_params, gan_params = of("encoder", "projection"), of("con_augment", "generator")
    real_grad, single = torch.autograd.grad, []

    def grad(outputs, inputs, *args, **kw):
        if isinstance(inputs, list) and len(inputs) == len(gan_params) + 1 and all(
                a is b for a, b in zip(inputs, gan_params)):
            single.append(real_grad(outputs, text_params + gan_params, retain_graph=True))
        return real_grad(outputs, inputs, *args, **kw)

    monkeypatch.setattr(torch.autograd, "grad", grad)
    system.train_step(batch, **step_kw)
    (want,) = single
    assert len(want) == len(text_params + gan_params) == len(of(*ts1.GEN_SIDE))
    for p, g in zip(text_params + gan_params, want):
        assert torch.equal(p.grad, g)
