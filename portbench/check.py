"""The comparison that decides ``correct``: the program's first steps
against the plain reference's, from the same weights, batches and draws.

Four numbers; a cell holds those its limits file names
(``limits/<cell>.json``) to their limits. The system names the step's
losses (``loss_names()``): the first, and a second where the step has
one.

* ``loss_gap``: the first step's first loss (StackGAN's critic loss,
  its last critic iteration's), relative to the reference's or to
  ``LOSS_SCALE``, whichever is larger;
* ``gen_loss_gap``: the same of the first step's second loss (StackGAN's
  generator loss, whose KL term sums over the batch's rows, so that a
  step over part of its rows reads that part's share of it; the loss is
  a bfloat16 sum whose last place is near a hundredth of it, which the
  limit leaves room for); a system with one loss has none;
* ``grad_norm_gap``: the first gradient as each compared optimizer took
  it (from Adam's first moment after step 1), leaf by leaf: the gap
  between the program's norm and the reference's, relative to the
  reference's norm of that leaf or of its optimizer's median leaf,
  whichever is larger; the worst leaf;
* ``change_norm_gap``: the same of each leaf's change over the
  ``STEPS`` steps, leaving out the leaves whose reference gradient is
  under ``QUIET`` of their optimizer's median leaf's (a bias that a
  following normalisation or the WGAN loss cancels, which moves under
  Adam by round-off alone).

Gaps of norms, not norms of differences: Adam's first updates are about
``lr * sign(g)``, so elements whose gradient is nought to rounding flip
sign between any two sound runs, and a norm of the difference would
count them. A step that leaves its state unchanged reads 1 in
``change_norm_gap``, one that moves it double reads 1 too.

What is compared, and why not more (the readings are in ``PERF.md``):
the later steps' losses part between any two sound runs, since the first
updates move every element by about ``lr`` whichever sign rounding gives
it; and the gradients of the modules the KL
term reaches (the conditioning augmentation, and in stage 1 the
projection and the text encoder) are ruled by ``1/sigma`` at the
``sigma`` nearest 0, where rounding decides size and sign. The system
names the optimizers whose leaves are compared (``compared_groups``).
"""

from __future__ import annotations

import statistics

import torch

STEPS = 3
LOSS_SCALE = 0.1
QUIET = 1e-3
NUMBERS = ("loss_gap", "gen_loss_gap", "grad_norm_gap", "change_norm_gap")


def as_floats(metrics: dict) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def _gaps(prog: dict, ref: dict, groups: dict) -> dict:
    """Each leaf's gap of norms, relative to the reference's norm of that
    leaf or of its group's median leaf, whichever is larger."""
    out = {}
    for names in groups.values():
        names = [n for n in names if n in ref]
        if not names:
            continue
        med = statistics.median(ref[n] for n in names)
        for n in names:
            out[n] = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
    return out


def _worst(gaps: dict) -> tuple:
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def _loss_gap(prog: dict, ref: dict, key: str) -> float:
    return abs(prog[key] - ref[key]) / max(abs(ref[key]), LOSS_SCALE)


def compare(prog: dict, ref: dict, theta0: dict, groups: dict, losses: tuple) -> dict:
    """``prog`` and ``ref``: ``{"metrics": [per step, floats], "grad":
    {leaf: norm}, "params": {leaf: tensor after STEPS steps}}``;
    ``theta0`` the initial parameters; ``groups`` each optimizer's
    leaves; ``losses`` the names of the step's one or two losses in its
    metrics. Returns each number, the leaf it came from and every leaf's
    readings."""
    if len(prog["metrics"]) != len(ref["metrics"]):
        raise ValueError("the program and the reference took different numbers of steps")
    step_gaps = [_loss_gap(mp, mr, losses[0]) for mp, mr in zip(prog["metrics"], ref["metrics"])]
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
    out = {"loss_gap": step_gaps[0]}
    if len(losses) > 1:
        out["gen_loss_gap"] = _loss_gap(prog["metrics"][0], ref["metrics"][0], losses[1])
    return {**out, "grad_norm_gap": grad, "change_norm_gap": chg,
            "leaves": {"grad_norm_gap": grad_leaf, "change_norm_gap": chg_leaf},
            "step_loss_gaps": step_gaps,
            "median": {"grad_norm_gap": statistics.median(grad_gaps.values()),
                       "change_norm_gap": statistics.median(change_gaps.values())},
            "per_leaf": {n: [prog["grad"][n], ref["grad"][n], grad_gaps[n],
                             change["prog"].get(n), change["ref"].get(n), change_gaps.get(n)] for n in names},
            "losses": {"program": prog["metrics"], "reference": ref["metrics"]},
            "left_out": sorted(set(names) - {n for v in moved.values() for n in v})}


def verdict(numbers: dict, limits: dict) -> tuple:
    """``(correct, [(name, number, limit)])`` over the numbers ``limits``
    names; a number that is not finite fails."""
    unread = [n for n in limits if n not in numbers]
    if unread:
        raise ValueError(f"the limits name {unread}, which this system's comparison does not read")
    rows = [(n, numbers[n], limits[n]) for n in NUMBERS if n in limits]
    ok = all(v == v and v <= lim for _, v, lim in rows)
    return ok, rows
