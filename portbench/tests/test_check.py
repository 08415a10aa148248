"""``check.compare`` takes the names of the step's losses from the
system: on both one-card cells' systems (tiny widths, the cells' bf16) it
reads, bit for bit, what the comparison read when it named StackGAN's
two losses itself; a system with one loss reads no ``gen_loss_gap``."""

from __future__ import annotations

import json
import statistics

import pytest
import torch

from portbench import check
from portbench.check import QUIET, _gaps, _loss_gap, _worst
from portbench.common import ROOT
from portbench.run import _first_steps, _reference_steps
from portbench.systems import stackgan
from portbench.systems.stackgan import System


def _compare_naming_stackgan(prog: dict, ref: dict, theta0: dict, groups: dict) -> dict:
    """``check.compare`` as it was when it named the losses
    ``loss_critic`` and ``loss_gen`` itself, kept whole to hold the new
    one to."""
    if len(prog["metrics"]) != len(ref["metrics"]):
        raise ValueError("the program and the reference took different numbers of steps")
    step_gaps = [_loss_gap(mp, mr, "loss_critic") for mp, mr in zip(prog["metrics"], ref["metrics"])]
    names = sorted(n for leaves in groups.values() for n in leaves)
    missing = [n for n in names if n not in prog["grad"] or n not in prog["params"]]
    if missing:
        raise ValueError(f"the program has no leaves {missing[:3]}...")
    grad_gaps = _gaps(prog["grad"], ref["grad"], groups)
    moved = {}
    for opt, leaves in groups.items():
        med = statistics.median(ref["grad"][n] for n in leaves)
        moved[opt] = [n for n in leaves if ref["grad"][n] >= QUIET * med]
    change = {}
    for side, snap in (("prog", prog), ("ref", ref)):
        change[side] = {n: float(torch.linalg.vector_norm(
            snap["params"][n].to(theta0[n].device).float() - theta0[n].float()))
            for leaves in moved.values() for n in leaves}
    change_gaps = _gaps(change["prog"], change["ref"], moved)
    grad, grad_leaf = _worst(grad_gaps)
    chg, chg_leaf = _worst(change_gaps)
    return {"loss_gap": step_gaps[0], "gen_loss_gap": _loss_gap(prog["metrics"][0], ref["metrics"][0], "loss_gen"),
            "grad_norm_gap": grad, "change_norm_gap": chg,
            "leaves": {"grad_norm_gap": grad_leaf, "change_norm_gap": chg_leaf},
            "step_loss_gaps": step_gaps,
            "median": {"grad_norm_gap": statistics.median(grad_gaps.values()),
                       "change_norm_gap": statistics.median(change_gaps.values())},
            "per_leaf": {n: [prog["grad"][n], ref["grad"][n], grad_gaps[n],
                             change["prog"].get(n), change["ref"].get(n), change_gaps.get(n)] for n in names},
            "losses": {"program": prog["metrics"], "reference": ref["metrics"]},
            "left_out": sorted(set(names) - {n for v in moved.values() for n in v})}


@pytest.fixture(scope="module", params=[1, 2])
def snapshots(request):
    """A one-card cell's system at tiny widths in its own bf16, the run's
    seed: the program's first steps and the reference's."""
    torch.set_num_threads(1)
    conf = json.loads((ROOT / "configs" / f"stackgan_stage{request.param}.json").read_text())
    mix = stackgan.tiny_mix(json.loads((ROOT / "traffic" / "short_captions_b256.json").read_text()))
    s = System(stackgan.tiny_config(conf), mix, 3_000_000_019, "cpu")
    s.build()
    prog = _first_steps(s, check.STEPS)
    theta0 = s.initial_params()
    ref = _reference_steps(s, s.reference(), theta0, s.shards, check.STEPS)
    return s, prog, ref, theta0


def test_numbers_as_before_the_losses_were_named(snapshots):
    s, prog, ref, theta0 = snapshots
    assert s.loss_names() == ("loss_critic", "loss_gen")
    new = check.compare(prog, ref, theta0, s.compared_groups(), s.loss_names())
    old = _compare_naming_stackgan(prog, ref, theta0, s.compared_groups())
    assert list(new) == list(old)
    for k in check.NUMBERS:
        assert new[k] == old[k], k  # bit for bit
    assert new == old


def test_one_loss_reads_no_gen_loss_gap(snapshots):
    s, prog, ref, theta0 = snapshots
    one = check.compare(prog, ref, theta0, s.compared_groups(), ("loss_critic",))
    both = check.compare(prog, ref, theta0, s.compared_groups(), s.loss_names())
    assert "gen_loss_gap" not in one
    assert all(one[k] == both[k] for k in ("loss_gap", "grad_norm_gap", "change_norm_gap"))
    limits = {k: v for k, v in stackgan.TINY_LIMITS.items() if k != "gen_loss_gap"}
    _, rows = check.verdict(one, limits)
    assert [r[0] for r in rows] == ["loss_gap", "grad_norm_gap", "change_norm_gap"]
    with pytest.raises(ValueError, match="gen_loss_gap"):
        check.verdict(one, stackgan.TINY_LIMITS)
