"""Rematerialisation (``Stage1Config.remat``, ``Stage2Config.remat``,
``ops/remat.py``) against the same steps without it, in f32 on the CPU:
the same initial state, batch and generators, two steps each.

The recomputed forwards run the same operations on the same inputs, so
the gradients and everything after them come out bit for bit; the
metrics are held at rtol 1e-5 (as the JAX package's own remat test,
``tests/test_step_options.py``) and the parameters, optimizer moments
and BatchNorm statistics after two steps bit-equal. Stage 1 runs with
text dropout on (its masks and the fused attention's seeds are drawn
before the checkpointed text forward and replayed), on the fused
attention route and on the einsum route; both stages run the gradient
penalty's double backward through a recomputed critic tower, whose
BatchNorm statistics must be written once per forward, not again by the
recomputation."""

import dataclasses

import numpy as np
import pytest
import torch

from imagegenerator_tpu_torch import convert
from imagegenerator_tpu_torch.models.bert import BertConfig
from imagegenerator_tpu_torch.ops.layers import BatchNorm
from imagegenerator_tpu_torch.ops.remat import remat
from imagegenerator_tpu_torch.train import stage1 as ts1
from imagegenerator_tpu_torch.train import stage2 as ts2
from tests.test_torch_stage1_step import _batch as batch1
from tests.test_torch_stage2_step import _batch as batch2

torch.set_num_threads(2)
RTOL = 1e-5


def _two_steps(system_cls, cfg, flat, batch, host=True):
    from_numpy = convert.stage1_from_numpy if system_cls is ts1.Stage1System else convert.stage2_from_numpy
    port = from_numpy(flat, cfg, "cpu")
    runs = []
    for seed in (3, 4):
        kw = dict(generator=torch.Generator().manual_seed(seed))
        if host:
            kw["host_generator"] = torch.Generator().manual_seed(seed + 100)
        runs.append({k: float(v) for k, v in port.train_step(batch, **kw).items()})
    return runs, convert.to_numpy(port)


def _same(with_remat, without, what):
    (m_on, flat_on), (m_off, flat_off) = with_remat, without
    for step, (a, b) in enumerate(zip(m_on, m_off), 1):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=RTOL, err_msg=f"{what} step {step} {k}")
            assert np.isfinite(a[k]), (what, k)
    assert set(flat_on) == set(flat_off)
    for k in flat_off:
        assert np.array_equal(flat_on[k], flat_off[k]), (what, k)


@pytest.mark.parametrize("fused", [True, False])
def test_stage1_remat_equals_no_remat_with_text_dropout(fused):
    bert = dataclasses.replace(BertConfig.tiny(), fused_attention=fused, fused_ln=fused)
    cfg = ts1.Stage1Config.tiny(n_critic=2, bert=bert)  # text dropout on, doubled batch
    assert cfg.text_dropout
    flat = convert.to_numpy(ts1.Stage1System(cfg, device="cpu", generator=torch.Generator().manual_seed(0)))
    batch = {k: torch.from_numpy(v) for k, v in batch1(cfg, True, seed=1).items()}
    on = _two_steps(ts1.Stage1System, dataclasses.replace(cfg, remat=True), flat, batch)
    off = _two_steps(ts1.Stage1System, cfg, flat, batch)
    _same(on, off, f"stage 1 fused={fused}")
    # the step did move the text encoder and the critic's statistics
    for prefix in ("params/encoder/", "batch_stats/critic/"):
        assert any(not np.array_equal(off[1][k], flat[k]) for k in flat if k.startswith(prefix)), prefix


def test_stage1_remat_reuse_mismatched():
    cfg = ts1.Stage1Config.tiny(n_critic=2, text_reuse_mismatched=True,
                                bert=dataclasses.replace(BertConfig.tiny(), fused_attention=True))
    flat = convert.to_numpy(ts1.Stage1System(cfg, device="cpu", generator=torch.Generator().manual_seed(2)))
    batch = {k: torch.from_numpy(v) for k, v in batch1(cfg, False, seed=2).items()}
    _same(_two_steps(ts1.Stage1System, dataclasses.replace(cfg, remat=True), flat, batch),
          _two_steps(ts1.Stage1System, cfg, flat, batch), "stage 1 reuse")


@pytest.mark.parametrize("route", ["tokens", "tem"])
def test_stage2_remat_equals_no_remat(route):
    cfg = ts2.Stage2Config.tiny(n_critic=2)
    flat = convert.to_numpy(ts2.Stage2System(cfg, device="cpu", generator=torch.Generator().manual_seed(0)))
    batch = {k: torch.from_numpy(np.array(v)) for k, v in batch2(cfg, route, True, seed=1).items()}
    _same(_two_steps(ts2.Stage2System, dataclasses.replace(cfg, remat=True), flat, batch, host=False),
          _two_steps(ts2.Stage2System, cfg, flat, batch, host=False), f"stage 2 {route}")


@pytest.mark.parametrize("fused", [True, False])
def test_bert_remat_recomputes_one_layer_at_a_time(fused):
    """``BertEncoder(..., remat=True)`` with dropout on and predrawn masks
    (fused attention's seeds or the einsum route's prob masks): the output
    and every gradient bit-equal to the plain forward's, and the backward
    recomputes the layers one at a time, last layer first, each between
    two layers' backward passes."""
    from imagegenerator_tpu_torch.models.bert import BertEncoder

    cfg = dataclasses.replace(BertConfig.tiny(), num_layers=3, fused_attention=fused, fused_ln=fused)
    enc = BertEncoder(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    ids = torch.randint(1, cfg.vocab_size, (4, 8), generator=torch.Generator().manual_seed(1))
    mask = (torch.arange(8)[None, :] < torch.tensor([[8], [5], [3], [8]])).int()
    predrawn = enc.draw(4, 8, "cpu", torch.Generator().manual_seed(2), torch.Generator().manual_seed(3))
    assert len(predrawn.masks) == (7 if fused else 10) and len(predrawn.seeds) == (3 if fused else 0)
    cot = torch.randn((4, 8, cfg.hidden_size), generator=torch.Generator().manual_seed(4))
    events = []
    for i, layer in enumerate(enc.encoder.layer):
        # a recomputation stops once it has what the backward needs, before
        # the layer returns: its first Dense marks that it ran
        layer.attention.self.query.register_forward_hook(lambda *_, i=i: events.append(("forward", i)))
        layer.output.dense.register_full_backward_hook(lambda *_, i=i: events.append(("backward", i)))
    outs = {}
    for remat in (False, True):
        events.clear()
        out = enc(ids, mask, deterministic=False, draws=predrawn.draws(), remat=remat)
        grads = torch.autograd.grad((out * cot).sum(), list(enc.parameters()))
        outs[remat] = (out.detach(), grads, list(events))
    assert torch.equal(outs[True][0], outs[False][0])
    for a, b in zip(outs[True][1], outs[False][1]):
        assert torch.equal(a, b)
    forwards = [("forward", i) for i in range(3)]
    assert outs[False][2] == forwards + [("backward", 2), ("backward", 1), ("backward", 0)]
    assert outs[True][2] == forwards + [("forward", 2), ("backward", 2), ("forward", 1), ("backward", 1),
                                        ("forward", 0), ("backward", 0)]
    with pytest.raises(ValueError, match="drawn beforehand"):
        enc(ids, mask, deterministic=False, generator=torch.Generator(), host_generator=torch.Generator(),
            remat=True)


def test_recomputation_writes_batchnorm_statistics_once():
    """One checkpointed tower pass under the gradient penalty's double
    backward (recomputed twice): the running statistics move as after one
    plain forward, and the second-order gradient is the plain one."""
    cfg = ts1.Stage1Config.tiny()
    gen = torch.Generator().manual_seed(0)
    critics = [ts1.StageIDiscriminator(cfg.tem_size, cfg.nd, cfg.disc_channels, device="cpu",
                                       generator=torch.Generator().manual_seed(1)) for _ in range(2)]
    images = torch.randn((4, cfg.resolution, cfg.resolution, 3), generator=gen)
    grads = []
    for critic, wrap in zip(critics, (False, True)):
        critic.train()
        x = images.clone().requires_grad_(True)
        feat = remat(critic.features, x) if wrap else critic.features(x)
        (g,) = torch.autograd.grad(feat.square().sum(), x, create_graph=True)
        tower = [p for n, p in critic.named_parameters() if not n.startswith("head.")]
        grads.append(torch.autograd.grad(g.square().sum(), tower))
    bns = [[m for m in c.modules() if isinstance(m, BatchNorm)] for c in critics]
    assert bns[0]
    for plain, wrapped in zip(*bns):
        assert not torch.equal(plain.running_mean, torch.zeros_like(plain.running_mean))
        assert torch.equal(plain.running_mean, wrapped.running_mean)
        assert torch.equal(plain.running_var, wrapped.running_var)
    for a, b in zip(*grads):
        assert torch.equal(a, b)
