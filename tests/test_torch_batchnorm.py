"""``ops/kernels/batchnorm.py`` on the CPU: the plain route of its
``autograd.Function``s (what ``ops/layers.py::BatchNorm`` runs on the
card, there on the kernels) against the layer's composition of PyTorch
ops differentiated by autograd (``BatchNorm.composition``, the CPU's
route), at small channels-last shapes with
C = 24, 80 and 640 (G1's last UpBlock, G2's last and its residual
blocks), in training mode, under ``statistics_frozen`` and in eval mode.

Held: the forward and the running statistics bit for bit (the same ops
in the same order); the gradients of a first-order loss and of a
penalty-shaped second-order one (the input gradient's norm, as the
WGAN-GP takes it, differentiated in the input, weight and bias) at
rtol 1e-5 / atol 1e-6 in f32 (the closed-form backward and autograd's
op-by-op one round differently); ``gradcheck`` and ``gradgradcheck`` in
float64; the clamp of the fast variance at its edge (a channel where
``E[x^2] - E[x]^2`` comes out below 0, which passes no gradient through
the variance, and one where it is exactly 0, which does); and ``sync``
over two gloo ranks (this file run as a script, ``python
tests/test_torch_batchnorm.py RANK PORT OUT``), each rank against the
composition over the same group and against one process on the whole
batch."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from imagegenerator_tpu_torch.ops import layers
from imagegenerator_tpu_torch.ops.kernels import batchnorm

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {24: (4, 24, 3, 3), 80: (2, 80, 4, 4), 640: (2, 640, 2, 2)}
TOL = dict(rtol=1e-5, atol=1e-6)


def functions(bn, x):
    """The layer's forward through ``batchnorm.batch_norm``'s Functions
    (on the CPU their plain route), with its parameters, statistics and
    group."""
    return batchnorm.batch_norm(
        x, bn.weight, bn.bias, bn.running_mean, bn.running_var, training=bn.training,
        update=bn.training and layers.statistics_frozen.writes, momentum=bn.momentum, eps=bn.eps,
        out_dtype=bn.dtype or torch.promote_types(x.dtype, torch.float32), sync=bn.sync,
        sync_size=bn.sync_size)


def _layer(C, training, seed, dtype=torch.float32):
    """A BatchNorm with seeded weight, bias and running statistics off
    their initial values, so that eval mode is not the identity."""
    g = torch.Generator().manual_seed(seed)
    bn = layers.BatchNorm(C).train(training)
    with torch.no_grad():
        bn.weight.copy_(1.0 + 0.3 * torch.randn(C, generator=g))
        bn.bias.copy_(0.3 * torch.randn(C, generator=g))
        bn.running_mean.copy_(0.3 * torch.randn(C, generator=g))
        bn.running_var.copy_(0.5 + torch.rand(C, generator=g))
    return bn.to(dtype)


def _input(shape, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    x = 1.5 * torch.randn(shape, generator=g, dtype=torch.float64) + 0.7
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


def _losses(fn, x, params, probe):
    """``(y, grads of a first-order loss, grads of a penalty)`` of ``fn``
    at x, over ``(x, *params)``: the loss ``sum(y * probe)``; the penalty
    ``sum((||d loss / dx||_2 - 1)^2)`` over the samples, as the WGAN-GP
    takes the input gradient's norm, plus half the loss. Both are sums, so
    that over ranks they add up to the whole batch's."""
    x = x.detach().requires_grad_(True)
    y = fn(x)
    first = (y * probe).sum()
    g1 = torch.autograd.grad(first, [x, *params], retain_graph=True)
    (gx,) = torch.autograd.grad(first, x, create_graph=True)
    norms = torch.sqrt(torch.sum(gx.reshape(x.shape[0], -1) ** 2, dim=1) + 1e-12)
    penalty = torch.sum((norms - 1.0) ** 2) + 0.5 * first
    g2 = torch.autograd.grad(penalty, [x, *params])
    return y, g1, g2


@pytest.mark.parametrize("mode", ["train", "frozen", "eval"])
@pytest.mark.parametrize("C", sorted(SHAPES))
def test_plain_route_matches_the_composition(C, mode):
    """Forward and running statistics bit for bit, first- and second-order
    gradients close, in training mode, under ``statistics_frozen`` and in
    eval mode."""
    shape = SHAPES[C]
    ours, theirs = _layer(C, mode != "eval", 1), _layer(C, mode != "eval", 1)
    x = _input(shape, 2)
    probe = torch.randn(shape, generator=torch.Generator().manual_seed(3))
    before = ours.running_mean.clone(), ours.running_var.clone()
    with layers.statistics_frozen() if mode == "frozen" else torch.enable_grad():
        y, g1, g2 = _losses(lambda t: functions(ours, t), x, [ours.weight, ours.bias], probe)
        want_y, want_g1, want_g2 = _losses(theirs.composition, x, [theirs.weight, theirs.bias],
                                           probe)
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y, want_y)
    assert torch.equal(ours.running_mean, theirs.running_mean)
    assert torch.equal(ours.running_var, theirs.running_var)
    moved = not torch.equal(ours.running_mean, before[0])
    assert moved == (mode == "train")
    for got, want in zip((*g1, *g2), (*want_g1, *want_g2)):
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("C,shape", [(24, (2, 24, 2, 2)), (80, (1, 80, 2, 2)), (640, (1, 640, 1, 2))])
def test_gradgradcheck_in_float64(C, shape, training):
    """The Functions' first and second derivatives against finite
    differences, in x, weight and bias, in float64 (which the plain route
    keeps)."""
    bn = _layer(C, training, 4, torch.float64)
    x = _input(shape, 5, torch.float64).requires_grad_(True)
    w = bn.weight.detach().clone().requires_grad_(True)
    b = bn.bias.detach().clone().requires_grad_(True)

    def fn(x, w, b):
        return batchnorm.batch_norm(x, w, b, bn.running_mean, bn.running_var, training=training, update=False,
                                    momentum=0.1, eps=1e-5, out_dtype=torch.float64)

    assert torch.autograd.gradcheck(fn, (x, w, b))
    assert torch.autograd.gradgradcheck(fn, (x, w, b), fast_mode=C == 640)


def _losses_bf16(fn, x, params, probe):
    """``_losses`` with ``tanh`` between y and the probe, so that the
    penalty reaches x through the forward too (as the critic's next layers
    do) and not only through the backward's own backward; sums in at
    least f32. Returns y and the six gradients."""
    x = x.detach().requires_grad_(True)
    y = fn(x)
    wide = torch.promote_types(y.dtype, torch.float32)
    first = (torch.tanh(y.to(wide)) * probe.to(wide)).sum()
    g1 = torch.autograd.grad(first, [x, *params], retain_graph=True)
    (gx,) = torch.autograd.grad(first, x, create_graph=True)
    norms = torch.sqrt(torch.sum(gx.to(wide).reshape(x.shape[0], -1) ** 2, dim=1) + 1e-12)
    g2 = torch.autograd.grad(torch.sum((norms - 1.0) ** 2) + 0.5 * first, [x, *params])
    return (y, *g1, *g2)


BF16_ROOM = 1.5  # over the composition's own distance from float64


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("C", sorted(SHAPES))
def test_bf16_lies_as_near_float64_as_the_composition(C, training):
    """In bf16 (the cells' dtype) the plain route and the composition
    round differently: the input gradient of the second order reaches x
    from the forward and from the backward's own backward, which the
    composition adds in f32 on its f32 rows and the Functions add in x's
    bf16, one rounding more. Both are held to the composition in float64
    on the same bf16 input: y and every gradient of the route within
    ``BF16_ROOM`` times the composition's relative distance from it (the
    route reads 1.0 to 1.26 times, the second-order input gradient the
    most, over three seeds of these shapes)."""
    shape = SHAPES[C]
    x = _input(shape, 9, torch.bfloat16)
    probe = torch.randn(shape, generator=torch.Generator().manual_seed(10), dtype=torch.float64)
    ours, theirs, wide = _layer(C, training, 11), _layer(C, training, 11), _layer(C, training, 11, torch.float64)
    ours.dtype = theirs.dtype = torch.bfloat16
    with layers.statistics_frozen():
        got = _losses_bf16(lambda t: functions(ours, t), x, [ours.weight, ours.bias], probe)
        comp = _losses_bf16(theirs.composition, x, [theirs.weight, theirs.bias], probe)
        f64 = _losses_bf16(wide.composition, x.double(), [wide.weight, wide.bias], probe)
    assert got[0].dtype == torch.bfloat16 and torch.equal(got[0], comp[0])
    for name, a, b, w in zip(("y", "dx", "dw", "db", "d2x", "d2w", "d2b"), got, comp, f64):
        far = lambda t: ((t.double() - w).norm() / w.norm()).item()
        assert far(a) <= BF16_ROOM * far(b), (name, far(a), far(b))


ENGAGED = (0.1, 0.2, 1.3, 5.1, 7.7)  # constants whose f32 sums may read E[x^2] < E[x]^2


@pytest.mark.parametrize("C", sorted(SHAPES))
def test_clamp_edge(C):
    """Channel 0 is constant at the first of ``ENGAGED`` whose f32 sums
    read ``E[x^2] - E[x]^2`` below 0: the clamp engages, the mask is 0 and
    the variance passes no gradient. Channel 1 is constant at 2, whose
    sums are exact: the difference is exactly 0, where ``clamp_min``
    passes the gradient, and so does the mask. Against the composition in
    f32 on every channel but 1, and on every channel against the
    composition in float64 on the same input (where channel 0's mean is
    exact), at atol 1e-4: f32 rounds a constant channel's mean by about
    an ulp, which rstd = eps^-1/2 takes to 1e-6 an element and its sums
    over the rows to 1e-4. At channel 1 the f32 composition's second-order
    input gradient is off by hundreds (its variance's backward cancels
    terms of order rstd^3), so f32 is held to float64 there."""
    shape = SHAPES[C]
    x = _input(shape, 6)
    n = shape[0] * shape[2] * shape[3]
    for value in ENGAGED:
        x[:, 0] = value
        r = batchnorm.rows(x)
        if ((r * r).sum(0) / n - (r.sum(0) / n) ** 2)[0] < 0:
            break
    x[:, 1] = 2.0
    r = batchnorm.rows(x)
    sums = batchnorm.batch_norm_sums_reference(batchnorm.FWD, r)
    _, stats = batchnorm.batch_norm_fwd_reference(
        r, sums, torch.ones(C), torch.zeros(C), torch.zeros(C), torch.ones(C), count=n, training=True,
        update=False, eps=1e-5, momentum=0.1, out_dtype=torch.float32)
    assert stats[2, 0] == 0 and stats[2, 1:].eq(1).all()
    assert (sums[1, 1] / n - (sums[0, 1] / n) ** 2) == 0
    ours, theirs, wide = _layer(C, True, 7), _layer(C, True, 7), _layer(C, True, 7, torch.float64)
    probe = torch.randn(shape, generator=torch.Generator().manual_seed(8))
    y, g1, g2 = _losses(lambda t: functions(ours, t), x, [ours.weight, ours.bias], probe)
    want_y, want_g1, want_g2 = _losses(theirs.composition, x, [theirs.weight, theirs.bias], probe)
    _, f64_g1, f64_g2 = _losses(wide.composition, x.double(), [wide.weight, wide.bias],
                                probe.double())
    assert torch.equal(y, want_y)
    others = [0] + list(range(2, C))
    for got, want, f64 in zip((*g1, *g2), (*want_g1, *want_g2), (*f64_g1, *f64_g2)):
        pick = (slice(None), others) if got.dim() == 4 else others
        torch.testing.assert_close(got[pick], want[pick], **TOL)
        torch.testing.assert_close(got.double(), f64, rtol=1e-5, atol=1e-4)


# ------------------------------------------------------------------ sync over two ranks
WORLD = 2


def _sync_case(C, training, bn_fn):
    """This rank's half of a seeded batch through ``bn_fn(layer, x)`` with
    the layer's moments over the group: y, the first- and second-order
    gradients, and the running statistics after."""
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_initialized() else None
    shape = SHAPES[C]
    whole = _input((shape[0] * WORLD, *shape[1:]), 9)
    probe = torch.randn(whole.shape, generator=torch.Generator().manual_seed(10))
    bn = _layer(C, training, 11)
    if rank is not None:
        rows = slice(rank * shape[0], (rank + 1) * shape[0])
        whole, probe = whole[rows].contiguous(memory_format=torch.channels_last), probe[rows]
        bn.sync, bn.sync_size = dist.group.WORLD, WORLD
    y, g1, g2 = _losses(lambda t: bn_fn(bn, t), whole, [bn.weight, bn.bias], probe)
    out = {"y": y, "running_mean": bn.running_mean, "running_var": bn.running_var}
    for name, grads in (("first", g1), ("second", g2)):
        out.update({f"{name}/{k}": v for k, v in zip(("x", "weight", "bias"), grads)})
    return {k: v.detach().numpy() for k, v in out.items()}


def _rank(rank, port, out):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=WORLD)
    arrays = {}
    for C in sorted(SHAPES):
        for training in (True, False):
            for route, fn in (("functions", functions), ("composition", lambda bn, t: bn.composition(t))):
                case = _sync_case(C, training, fn)
                arrays.update({f"{C}/{training}/{route}/{k}": v for k, v in case.items()})
    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def sync_ranks(tmp_path_factory):
    from tests.test_torch_tp import _free_port

    out = tmp_path_factory.mktemp("bn_sync")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = []
    try:
        for r in range(WORLD):
            log = open(out / f"rank{r}.log", "w")
            procs.append((subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(port), str(out)],
                                           stdout=log, stderr=subprocess.STDOUT, cwd=ROOT, env=env), log))
        for p, _ in procs:
            p.wait(timeout=240)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for r, (p, _) in enumerate(procs):
        assert p.returncode == 0, (out / f"rank{r}.log").read_text()[-4000:]
    ranks = []
    for r in range(WORLD):
        with np.load(out / f"rank{r}.npz") as f:
            ranks.append({k: f[k] for k in f.files})
    return ranks


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("C", sorted(SHAPES))
def test_sync_over_two_gloo_ranks(sync_ranks, C, training):
    """Each rank's Functions against the composition over the same group
    (y and statistics bit for bit, gradients close), and the ranks together
    against one process on the whole batch: y and the input gradients are
    the whole batch's rows; weight and bias gradients summed over the
    ranks are the whole batch's."""
    whole = _sync_case(C, training, functions)
    half = SHAPES[C][0]
    for r, arrays in enumerate(sync_ranks):
        got = {k.split("/", 3)[3]: v for k, v in arrays.items() if k.startswith(f"{C}/{training}/functions/")}
        want = {k.split("/", 3)[3]: v for k, v in arrays.items() if k.startswith(f"{C}/{training}/composition/")}
        assert got.keys() == want.keys()
        for k in ("y", "running_mean", "running_var"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in got:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
        rows = slice(r * half, (r + 1) * half)
        for k in ("y", "first/x", "second/x"):
            np.testing.assert_allclose(got[k], whole[k][rows], err_msg=k, rtol=1e-5, atol=1e-5)
        for k in ("running_mean", "running_var"):
            np.testing.assert_allclose(got[k], whole[k], err_msg=k, rtol=1e-5, atol=1e-6)
    for k in ("first/weight", "first/bias", "second/weight", "second/bias"):
        total = sum(arrays[f"{C}/{training}/functions/{k}"] for arrays in sync_ranks)
        np.testing.assert_allclose(total, whole[k], err_msg=k, rtol=1e-5, atol=1e-5)


if __name__ == "__main__":
    r, port, out_dir = sys.argv[1:]
    _rank(int(r), int(port), out_dir)
