"""The port's codebook search and straight-through quantization against
the JAX package on the CPU: ``vq_argmin`` (on a CPU tensor its plain
version) against the Pallas kernel in interpret mode and against the XLA
path, on inputs from a numpy seed.

Tolerances: on random f32 inputs two sound routes may name different
codes only where the two codes are equally near to rounding: the squared
distances of the chosen codes must agree to rtol = atol = 1e-5 (the JAX
package's own test's rule). Where every score is exact in f32 (integer
inputs) the indices must be equal, ties to the lowest index, in all four
routes. ``vector_quantize``: value equal (a lookup), gradient equal (the
identity).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagegenerator_tpu.ops import quantize as jq
from imagegenerator_tpu.ops.pallas.vq_kernel import nearest_codebook_indices_pallas
from imagegenerator_tpu_torch.ops import quantize as tq
from imagegenerator_tpu_torch.ops.kernels import vq_argmin


def _inputs(n, k, d, seed, kind="normal"):
    rng = np.random.default_rng(seed)
    if kind == "taming":
        cb = rng.uniform(-1.0 / k, 1.0 / k, (k, d)).astype(np.float32)
        x = cb[rng.integers(0, k, n)] + rng.uniform(-0.5 / k, 0.5 / k, (n, d)).astype(np.float32)
    else:
        cb = rng.normal(size=(k, d)).astype(np.float32)
        x = rng.normal(size=(n, d)).astype(np.float32)
    return x, cb


def _same_or_as_near(got, want, x, cb):
    if not np.array_equal(got, want):
        x, cb = x.astype(np.float64), cb.astype(np.float64)
        d_want = np.sum((x - cb[want]) ** 2, axis=1)
        d_got = np.sum((x - cb[got]) ** 2, axis=1)
        np.testing.assert_allclose(d_got, d_want, rtol=1e-5, atol=1e-5)


# K and N off every tile size of either kernel (64; 256 and 2048)
@pytest.mark.parametrize("kind", ["normal", "taming"])
@pytest.mark.parametrize("n,k,d", [(64, 512, 128), (300, 2048, 128), (17, 3000, 256), (37, 33, 128)])
def test_plain_version_matches_pallas_interpret_and_xla(n, k, d, kind):
    x, cb = _inputs(n, k, d, seed=n + k, kind=kind)
    got = vq_argmin.vq_argmin(torch.from_numpy(x), torch.from_numpy(cb))
    assert got.dtype == torch.int32 and got.shape == (n,)
    pallas = np.asarray(nearest_codebook_indices_pallas(jnp.asarray(x), jnp.asarray(cb), interpret=True))
    xla = np.asarray(jq.nearest_codebook_indices(jnp.asarray(x), jnp.asarray(cb), use_pallas=False))
    _same_or_as_near(got.numpy(), pallas, x, cb)
    _same_or_as_near(got.numpy(), xla, x, cb)


def test_planted_ties_go_to_the_lowest_index_in_every_route():
    rng = np.random.default_rng(7)
    k, d, n = 2100, 128, 70
    cb = rng.integers(-2, 3, (k, d)).astype(np.float32)
    cb[k - 1], cb[k // 2 + 3], cb[2050] = cb[5], cb[5], cb[64]  # duplicates across tiles
    x = rng.integers(-2, 3, (n, d)).astype(np.float32)
    x[0], x[1], x[2] = cb[5], cb[64], cb[k - 1]
    port = vq_argmin.vq_argmin(torch.from_numpy(x), torch.from_numpy(cb)).numpy()
    via_quantize = tq.nearest_codebook_indices(torch.from_numpy(x), torch.from_numpy(cb)).numpy()
    pallas = np.asarray(nearest_codebook_indices_pallas(jnp.asarray(x), jnp.asarray(cb), interpret=True))
    xla = np.asarray(jq.nearest_codebook_indices(jnp.asarray(x), jnp.asarray(cb), use_pallas=False))
    assert port[:3].tolist() == [5, 64, 5]
    np.testing.assert_array_equal(port, via_quantize)
    np.testing.assert_array_equal(port, pallas)
    np.testing.assert_array_equal(port, xla)
    # and the first minimum by brute force, in exact integer arithmetic
    scores = (cb.astype(np.int64) ** 2).sum(1)[None] - 2 * x.astype(np.int64) @ cb.astype(np.int64).T
    np.testing.assert_array_equal(port, scores.argmin(axis=1))


def test_bf16_rows_are_widened_not_the_codebook():
    x, cb = _inputs(40, 500, 128, seed=3)
    xb = torch.from_numpy(x).bfloat16()
    got = vq_argmin.vq_argmin(xb, torch.from_numpy(cb)).numpy()
    xw = xb.float().numpy()
    pallas = np.asarray(nearest_codebook_indices_pallas(
        jnp.asarray(xw).astype(jnp.bfloat16), jnp.asarray(cb), interpret=True))
    _same_or_as_near(got, pallas, xw, cb)


def test_nearest_codebook_indices_shapes_and_switch():
    x, cb = _inputs(2 * 3 * 4, 64, 8, seed=5)
    xt = torch.from_numpy(x).reshape(2, 3, 4, 8).requires_grad_(True)
    idx = tq.nearest_codebook_indices(xt, torch.from_numpy(cb))
    assert idx.shape == (2, 3, 4) and idx.dtype == torch.int32 and not idx.requires_grad
    forced = tq.nearest_codebook_indices(xt, torch.from_numpy(cb), use_kernel=False)
    assert torch.equal(idx, forced)
    want = np.asarray(jq.nearest_codebook_indices(jnp.asarray(x).reshape(2, 3, 4, 8), jnp.asarray(cb)))
    np.testing.assert_array_equal(idx.numpy(), want)


def test_vector_quantize_value_and_straight_through_gradient():
    x, cb = _inputs(30, 64, 8, seed=9)
    cot = np.random.default_rng(1).normal(size=(2, 15, 8)).astype(np.float32)
    xt = torch.from_numpy(x).reshape(2, 15, 8).requires_grad_(True)
    cbt = torch.from_numpy(cb).requires_grad_(True)
    out = tq.vector_quantize(xt, cbt)
    out.backward(torch.from_numpy(cot))
    want, vjp = jax.vjp(lambda a: jq.vector_quantize(a, jnp.asarray(cb)), jnp.asarray(x).reshape(2, 15, 8))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]))
    np.testing.assert_array_equal(xt.grad.numpy(), cot)
    assert cbt.grad is None


def test_wrapper_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match="device"):
        vq_argmin.vq_argmin(torch.zeros((4, 8), device="meta"), torch.zeros((16, 8), device="meta"))
    assert vq_argmin.k_splits(64, 16384) == 256 and vq_argmin.k_splits(4096, 16384) == 16
    assert vq_argmin.k_splits(10**6, 16384) == 1 and vq_argmin.k_splits(64, 100) == 2
