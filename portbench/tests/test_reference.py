"""The plain reference against the port's tiny steps (``Stage1Config.tiny()``
and ``Stage2Config.tiny()`` widths) under the same ``noise=`` draws, in
f32 on the CPU, where both compute the same arithmetic up to the order of
a few sums."""

from __future__ import annotations

import json

import pytest
import torch

from portbench import check
from portbench.common import ROOT
from portbench.run import _first_steps, _reference_steps
from portbench.systems import stackgan
from portbench.systems.stackgan import System


def _system(stage, dtype="float32", **overrides):
    conf = json.loads((ROOT / "configs" / f"stackgan_stage{stage}.json").read_text())
    conf = stackgan.tiny_config(conf, compute_dtype=dtype, **overrides)
    mix = stackgan.tiny_mix(json.loads((ROOT / "traffic" / "short_captions_b256.json").read_text()))
    return System(conf, mix, 2**40 + 3, "cpu")


@pytest.mark.parametrize("stage", [1, 2])
def test_reference_follows_the_tiny_step(stage):
    torch.set_num_threads(1)
    s = _system(stage)
    s.build()
    prog = _first_steps(s, check.STEPS)
    theta0 = s.initial_params()
    ref = _reference_steps(s, s.reference(), theta0, s.shards, check.STEPS)
    for mp, mr in zip(prog["metrics"], ref["metrics"]):
        for k in mr:
            assert mp[k] == pytest.approx(mr[k], rel=1e-4, abs=1e-5), k
    # every trained leaf, not only the compared ones: the first gradient
    for name, g in ref["grad"].items():
        assert prog["grad"][name] == pytest.approx(g, rel=1e-3, abs=1e-6), name
    numbers = check.compare(prog, ref, theta0, s.compared_groups(), s.loss_names())
    assert numbers["loss_gap"] < 1e-5 and numbers["gen_loss_gap"] < 1e-5 and numbers["grad_norm_gap"] < 1e-4
    assert numbers["change_norm_gap"] < 0.05


def test_reference_replays_the_attention_dropout():
    """Stage 1 with dropout: the port's fused attention draws its keep bits
    from the counter hash; the reference's frozen copy gives the same
    first-step losses. Shifting the seeds changes them."""
    torch.set_num_threads(1)
    s = _system(1)
    s.build()
    noise = s.noise(0)
    m = check.as_floats(s.step(0, noise))
    theta0 = s.initial_params()
    r = s.reference()
    got = check.as_floats(r.step(r.init_state(theta0), [(s.batch(0), noise)]))
    assert m["loss_critic"] == pytest.approx(got["loss_critic"], rel=1e-5)
    shifted = dict(noise, attn_seeds=[x + 1 for x in noise["attn_seeds"]])
    other = check.as_floats(r.step(r.init_state(theta0), [(s.batch(0), shifted)]))
    assert other["loss_critic"] != pytest.approx(got["loss_critic"], rel=1e-6)


def test_initial_weights_are_seeded():
    s, t = _system(2), _system(2)
    s.plan()
    t.plan()
    a, b = s.initial_params(), t.initial_params()
    assert all(torch.equal(a[k], b[k]) for k in a)
    t.seed += 1
    c = t.initial_params()
    assert not torch.equal(a["gen_2.Conv2d_0.weight"], c["gen_2.Conv2d_0.weight"])
    assert torch.equal(a["gen_2.DownBlock_0.BatchNorm_0.running_var"], c["gen_2.DownBlock_0.BatchNorm_0.running_var"])
