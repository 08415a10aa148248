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
    # a tile of the tensor-core kernel holds 128 codes (64 before): 16384
    # codes are 128 tiles, so one row tile splits K 128 ways (256 before),
    # and 100 codes are one tile (two before)
    assert vq_argmin.k_splits(64, 16384) == 128 and vq_argmin.k_splits(4096, 16384) == 16
    assert vq_argmin.k_splits(10**6, 16384) == 1 and vq_argmin.k_splits(64, 100) == 1
    assert vq_argmin.k_splits(64, 129) == 2 and vq_argmin.k_splits(256, 16384) == 128


# ------------------------------------------ the kernel's 3xTF32 arithmetic


def test_split_tf32_halves():
    rng = np.random.default_rng(11)
    t = torch.from_numpy((rng.normal(size=4096) * 10.0 ** rng.integers(-6, 6, 4096)).astype(np.float32))
    hi, lo = vq_argmin.split_tf32(t)
    assert hi.dtype == lo.dtype == torch.float32
    for part in (hi, lo):  # TF32 values: the low 13 bits of the pattern are clear
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    # round to nearest: hi within half a TF32 step (2^-11 relative), and
    # hi + lo gives t back to 2^-21 relative
    assert float(((hi - t).abs() / t.abs()).max()) <= 2.0**-11
    assert float(((hi.double() + lo.double() - t.double()).abs() / t.double().abs()).max()) <= 2.0**-21
    # ties go away from zero, as cvt.rna rounds: 1 + 2^-11 is halfway
    # between the TF32 values 1 and 1 + 2^-10
    tie = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11)])
    assert vq_argmin.split_tf32(tie)[0].tolist() == [1.0 + 2.0**-10, -(1.0 + 2.0**-10)]


def test_split_tf32_of_small_integers_has_no_low_part():
    t = torch.arange(-2, 3, dtype=torch.float32).repeat(7)
    hi, lo = vq_argmin.split_tf32(t)
    assert torch.equal(hi, t) and int(lo.count_nonzero()) == 0
    wide = torch.tensor([1024.0, -1023.0, 2047.0])  # 11 bits with the hidden one
    assert torch.equal(vq_argmin.split_tf32(wide)[0], wide)


@pytest.mark.parametrize("kind", ["normal", "taming"])
@pytest.mark.parametrize("n,k,d", [(64, 2048, 256), (300, 2048, 128)])
def test_three_tf32_products_match_plain_and_pallas(n, k, d, kind):
    x, cb = _inputs(n, k, d, seed=n + d, kind=kind)
    got = vq_argmin.vq_argmin_reference_3xtf32(torch.from_numpy(x), torch.from_numpy(cb))
    assert got.dtype == torch.int32 and got.shape == (n,)
    plain = vq_argmin.vq_argmin_reference(torch.from_numpy(x), torch.from_numpy(cb)).numpy()
    pallas = np.asarray(nearest_codebook_indices_pallas(jnp.asarray(x), jnp.asarray(cb), interpret=True))
    _same_or_as_near(got.numpy(), plain, x, cb)
    _same_or_as_near(got.numpy(), pallas, x, cb)


def test_three_tf32_products_keep_planted_ties_exact():
    rng = np.random.default_rng(7)
    k, d, n = 2100, 128, 70
    cb = rng.integers(-2, 3, (k, d)).astype(np.float32)
    cb[k - 1], cb[k // 2 + 3], cb[2050] = cb[5], cb[5], cb[64]
    x = rng.integers(-2, 3, (n, d)).astype(np.float32)
    x[0], x[1], x[2] = cb[5], cb[64], cb[k - 1]
    got = vq_argmin.vq_argmin_reference_3xtf32(torch.from_numpy(x), torch.from_numpy(cb)).numpy()
    assert got[:3].tolist() == [5, 64, 5]
    np.testing.assert_array_equal(
        got, vq_argmin.vq_argmin_reference(torch.from_numpy(x), torch.from_numpy(cb)).numpy())
    pallas = np.asarray(nearest_codebook_indices_pallas(jnp.asarray(x), jnp.asarray(cb), interpret=True))
    np.testing.assert_array_equal(got, pallas)
    bf = vq_argmin.vq_argmin_reference_3xtf32(torch.from_numpy(x).bfloat16(), torch.from_numpy(cb)).numpy()
    np.testing.assert_array_equal(got, bf)  # these integers are bf16 values


def _gap_to_best(idx, x, cb):
    """The score of each row's code ``idx`` over the row's best, as a
    share of the row's score range, in f64."""
    cbd = cb.double()
    scores = (cbd * cbd).sum(dim=1)[None, :] - 2.0 * x.double() @ cbd.t()
    low = scores.amin(dim=1)
    return (scores.gather(1, idx.long()[:, None])[:, 0] - low) / (scores.amax(dim=1) - low)


# why three products: one TF32 product names a code further from the best
# than the 1e-5 of the row's score range that the card's checks allow; the
# split names the best code. Seeds that show it (a miss is rare: about one
# row in a thousand).
@pytest.mark.parametrize("n,k,d,seed", [(512, 16384, 256, 2), (1024, 4096, 8, 0), (1024, 4096, 8, 3)])
def test_one_tf32_product_misses_where_three_do_not(n, k, d, seed):
    x, cb = (torch.from_numpy(a) for a in _inputs(n, k, d, seed))
    x_hi, c_hi = vq_argmin.split_tf32(x)[0], vq_argmin.split_tf32(cb)[0]
    one_pass = ((cb * cb).sum(dim=1)[None, :] - 2.0 * (x_hi @ c_hi.t())).argmin(dim=1)
    assert float(_gap_to_best(one_pass, x, cb).max()) > 1e-5
    three = vq_argmin.vq_argmin_reference_3xtf32(x, cb)
    assert float(_gap_to_best(three, x, cb).max()) <= 1e-5


# ------------------------------------------------- the wrapper's scratch


def test_new_scratch_holds_what_the_kernel_expects():
    keys, tickets = vq_argmin._new_scratch(130, torch.device("cpu"))
    assert keys.dtype == torch.int64 and keys.shape == (130,) and bool((keys == -1).all())  # all ones
    assert tickets.dtype == torch.int32 and tickets.shape == (3,) and int(tickets.count_nonzero()) == 0


def test_each_device_and_stream_gets_its_own_scratch(monkeypatch):
    monkeypatch.setattr(vq_argmin, "_scratch", {})
    made = []

    def make(capacity, device):
        made.append((capacity, str(device)))
        return vq_argmin._new_scratch(capacity, torch.device("cpu"))

    first = vq_argmin.scratch_for(0, 111, 64, make)
    assert vq_argmin.scratch_for(0, 111, 10, make) is first  # same stream, fits: reused
    other_stream = vq_argmin.scratch_for(0, 222, 64, make)
    other_device = vq_argmin.scratch_for(1, 111, 64, make)
    assert len({t[0].data_ptr() for t in (first, other_stream, other_device)}) == 3
    grown = vq_argmin.scratch_for(0, 111, 65, make)  # outgrown: a new one, whole row tiles
    assert grown is not first and grown[0].shape == (128,) and grown[1].shape == (2,)
    assert vq_argmin.scratch_for(0, 111, 128, make) is grown
    assert vq_argmin.scratch_for(0, 222, 1, make) is other_stream
    assert made == [(64, "cuda:0"), (64, "cuda:0"), (64, "cuda:1"), (128, "cuda:0")]
    assert set(vq_argmin._scratch) == {(0, 111), (0, 222), (1, 111)}
