"""The port's attention (``ops/kernels/attention.py``) on the CPU: the
plain forward against the JAX package's Pallas forward ``_pallas_fwd``
run in interpret mode, output by output (o, m, l); with dropout, the
keep-mask bit for bit against the interpret-mode ``_keep_mask`` and the
output and its vjp (dq, dk, dv) against JAX ``fused_attention(...,
interpret=True)`` with the same seed, with and without a mask and with a
fully masked row; the wrappers' contract (a CPU tensor takes the
plain version and counts no launch) and the (dtype, T) rule that names
the kernels a CUDA tensor takes. The CUDA kernels themselves are
held to the plain versions on the card by ``chip_smoke.py`` and
``tests/test_torch_kernels_cuda.py``.

Tolerance: rtol = atol = 1e-5 (plain version of a kernel)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagegenerator_tpu.ops.pallas import attention as jattn
from imagegenerator_tpu_torch.ops.kernels import attention

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(B, T, H, mask_kind, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, T, H)).astype(np.float32) for _ in range(3))
    if mask_kind is None:
        return q, k, v, None
    mask = np.ones((B, T), np.int32)
    for b in range(1, B):
        mask[b, T - (b * T) // (B + 1):] = 0
    if mask_kind == "fully_masked_row":
        mask[-1] = 0
    return q, k, v, mask


def _jax_fwd(q, k, v, mask, nh, dtype=jnp.float32):
    has_mask = mask is not None
    rest = (jnp.asarray(mask).reshape(mask.shape[0], 1, -1),) if has_mask else ()
    rest += tuple(jnp.asarray(a, dtype) for a in (q, k, v))
    o, m, l = jattn._pallas_fwd(
        jnp.zeros((3,), jnp.int32), *rest, nhH=(nh, q.shape[2]), rate=0.0,
        hw_prng=False, interpret=True, has_mask=has_mask,
    )
    return np.asarray(o, np.float32), np.asarray(m), np.asarray(l)


@pytest.mark.parametrize("mask_kind", ["ragged", "fully_masked_row", None])
@pytest.mark.parametrize("B,T,H,nh", [(3, 16, 64, 2), (2, 128, 768, 12)])
def test_plain_matches_pallas_forward(B, T, H, nh, mask_kind):
    q, k, v, mask = _inputs(B, T, H, mask_kind)
    want = _jax_fwd(q, k, v, mask, nh)
    t = lambda a: None if a is None else torch.from_numpy(a)
    got = attention.attention_reference(t(q), t(k), t(v), t(mask), nh)
    for name, g, w in zip("oml", got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)


def test_fully_masked_row_is_uniform():
    q, k, v, mask = _inputs(3, 16, 64, "fully_masked_row")
    o, m, l = attention.attention_reference(*map(torch.from_numpy, (q, k, v, mask)), 2)
    np.testing.assert_allclose(m[-1].numpy(), attention.BIG_NEG)
    np.testing.assert_allclose(l[-1].numpy(), 16.0)
    mean_v = v[-1].mean(axis=0)
    np.testing.assert_allclose(o[-1].numpy(), np.broadcast_to(mean_v, (16, 64)), **TOL)


def test_bf16_rounds_probs_to_v_dtype():
    """As in the TPU kernel: p is rounded to v's dtype before p V and the
    output comes back in q's dtype."""
    q, k, v, mask = _inputs(2, 16, 64, "ragged", seed=1)
    tb = lambda a: torch.from_numpy(a).bfloat16()
    o, m, l = attention.attention_reference(tb(q), tb(k), tb(v), torch.from_numpy(mask), 2)
    assert o.dtype == torch.bfloat16 and m.dtype == l.dtype == torch.float32
    want = _jax_fwd(q, k, v, mask, 2, jnp.bfloat16)
    # one bf16 rounding of o apart at most
    np.testing.assert_allclose(o.float().numpy(), want[0], rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(m.numpy(), want[1], **TOL)
    np.testing.assert_allclose(l.numpy(), want[2], **TOL)


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    q, k, v, mask = map(torch.from_numpy, _inputs(2, 16, 64, "ragged"))
    attention.launches = 0
    o = attention.fused_attention(q, k, v, mask.long(), num_heads=2)
    assert attention.launches == 0
    want = attention.attention_reference(q, k, v, mask, 2)[0]
    assert torch.equal(o, want)


@pytest.mark.parametrize("dtype,T,route", [
    (torch.bfloat16, 1, "mma"), (torch.bfloat16, 77, "mma"), (torch.bfloat16, 128, "mma"),
    (torch.bfloat16, 129, "fma"), (torch.bfloat16, 512, "fma"),
    (torch.float32, 1, "fma"), (torch.float32, 77, "fma"), (torch.float32, 128, "fma"),
    (torch.float32, 129, "fma"), (torch.float32, 512, "fma"),
])
def test_kernel_route_is_a_rule_on_dtype_and_length(dtype, T, route):
    """Tensor cores for bf16 at T <= 128, the FMA kernels for f32 (which
    would mean TF32) and for longer sequences."""
    assert attention.kernel_route(dtype, T) == route
    assert attention.MMA_MAX_SEQ == 128 and attention.MAX_SEQ == 512


@pytest.mark.parametrize("dtype,T", [(torch.bfloat16, 77), (torch.bfloat16, 128), (torch.float32, 129)])
def test_cpu_tensor_takes_plain_version_whatever_the_route(dtype, T):
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, T, 64)).astype(np.float32)).to(dtype)
                   for _ in range(4))
    attention.launches = attention.mma_launches = 0
    attention.bwd_launches = attention.mma_bwd_launches = 0
    o, m, l = attention.attention_fwd(q, k, v, None, 1, 0.1, 3)
    grads = attention.attention_bwd(q, k, v, do, None, m, l, 1, 0.1, 3)
    assert (attention.launches, attention.mma_launches) == (0, 0)
    assert (attention.bwd_launches, attention.mma_bwd_launches) == (0, 0)
    want = attention.attention_reference(q, k, v, None, 1, 0.1, 3)
    assert all(torch.equal(a, b) for a, b in zip((o, m, l), want))
    want = attention.attention_bwd_reference(q, k, v, do, None, m, l, 1, 0.1, 3)
    assert all(torch.equal(a, b) and a.dtype == dtype for a, b in zip(grads, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fully_masked_row_sums_over_its_own_77_keys(dtype):
    """T = 77 is padded to 80 or 128 inside a kernel. The plain version the
    kernels are held to counts no padding: a fully masked row has
    m = -3e7, l = 77 and uniform probabilities 1 / 77 (o is the mean of
    v, dv spreads do evenly), and no gradient reaches its q and k."""
    B, T, H, nh = 3, 77, 128, 2
    q, k, v, mask = _inputs(B, T, H, "fully_masked_row", seed=6)
    do = np.random.default_rng(7).standard_normal((B, T, H)).astype(np.float32)
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in (q, k, v, do))
    mask = torch.from_numpy(mask)
    o, m, l = attention.attention_reference(q, k, v, mask, nh)
    np.testing.assert_array_equal(m[-1].numpy(), np.float32(attention.BIG_NEG))
    np.testing.assert_array_equal(l[-1].numpy(), np.float32(T))
    tol = TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    mean_v = v[-1].float().mean(dim=0)
    np.testing.assert_allclose(o[-1].float().numpy(), mean_v.expand(T, H).numpy(), **tol)
    dq, dk, dv = attention.attention_bwd_reference(q, k, v, do, mask, m, l, nh)
    assert not dq[-1].any() and not dk[-1].any()
    uniform = (do[-1].float().sum(dim=0) / T).expand(T, H)
    np.testing.assert_allclose(dv[-1].float().numpy(), uniform.numpy(), **tol)
    # a row with kept keys is not touched by the masked ones: l counts them
    assert float(l[0].min()) >= 1.0 and float(l[1].max()) <= float(mask[1].sum())


@pytest.mark.parametrize("seed", [0, 123456789, -987654321, 2**31 - 1])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_mask_is_the_interpret_mode_hash_bit_for_bit(rate, seed):
    B, nh, T = 3, 4, 24
    got = attention.keep_mask(B, nh, T, seed, rate).numpy()
    seed_ref = jnp.asarray([seed, 0, 0], jnp.int32)
    for b in range(B):
        for h in range(nh):
            want = jattn._keep_mask((T, T), rate, False, seed_ref, b, 1, 0, h)
            np.testing.assert_array_equal(got[b, h], np.asarray(want) > 0, err_msg=f"row {b} head {h}")
    assert abs(got.mean() - (1 - rate)) < 0.05


def test_keep_rate_and_threshold():
    keep = attention.keep_mask(8, 12, 128, 7, 0.1)
    assert abs(keep.float().mean().item() - 0.9) < 0.002
    assert attention.threshold(0.1) == int(0.1 * 2**32)
    assert attention.threshold(1.0) == 2**32 - 1


def _jax_attention(q, k, v, mask, nh, rate, seed):
    t = lambda a: jnp.asarray(a)
    fn = lambda q, k, v: jattn.fused_attention(
        q, k, v, None if mask is None else t(mask), jnp.asarray([seed], jnp.int32),
        num_heads=nh, dropout_rate=rate, interpret=True)
    return jax.vjp(fn, t(q), t(k), t(v))


@pytest.mark.parametrize("mask_kind", ["ragged", "fully_masked_row", None])
@pytest.mark.parametrize("rate,seed", [(0.0, 0), (0.1, 42), (0.5, -7)])
def test_dropout_forward_and_vjp_match_jax(rate, seed, mask_kind):
    B, T, H, nh = 3, 16, 128, 2
    q, k, v, mask = _inputs(B, T, H, mask_kind, seed=3)
    do = np.random.default_rng(4).standard_normal((B, T, H)).astype(np.float32)
    want, vjp = _jax_attention(q, k, v, mask, nh, rate, seed)
    want_grads = vjp(jnp.asarray(do))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    mt = None if mask is None else torch.from_numpy(mask)
    got = attention.fused_attention(qt, kt, vt, mt, num_heads=nh, dropout_rate=rate, seed=seed)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    got.backward(torch.from_numpy(do))
    for name, g, w in zip(("dq", "dk", "dv"), (qt.grad, kt.grad, vt.grad), want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)
    if mask_kind == "fully_masked_row":  # no gradient reaches a row's masked logits
        assert not qt.grad[-1].any() and not kt.grad[-1].any()


def test_dropout_masks_differ_by_seed_and_replay_in_the_backward():
    q, k, v, mask = map(torch.from_numpy, _inputs(2, 16, 64, "ragged"))
    a, m, l = attention.attention_reference(q, k, v, mask, 1, 0.3, 1)
    b = attention.attention_reference(q, k, v, mask, 1, 0.3, 2)[0]
    assert not torch.equal(a, b)
    assert torch.equal(a, attention.attention_fwd(q, k, v, mask, 1, 0.3, 1)[0])
    # the statistics are taken before dropout, as on the TPU
    _, m0, l0 = attention.attention_reference(q, k, v, mask, 1)
    assert torch.equal(m, m0) and torch.equal(l, l0)
    with pytest.raises(ValueError, match="rate"):
        attention.attention_fwd(q, k, v, mask, 1, 1.0, 1)


def test_bwd_wrapper_takes_the_plain_version_on_cpu():
    q, k, v, mask = map(torch.from_numpy, _inputs(2, 16, 64, "ragged"))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(0))
    _, m, l = attention.attention_fwd(q, k, v, mask, 1, 0.2, 5)
    attention.bwd_launches = 0
    got = attention.attention_bwd(q, k, v, do, mask, m, l, 1, 0.2, 5)
    assert attention.bwd_launches == 0
    want = attention.attention_bwd_reference(q, k, v, do, mask, m, l, 1, 0.2, 5)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_no_kernel_for_other_devices():
    q = torch.zeros(1, 8, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        attention.attention_fwd(q, q, q, None, 1)
    with pytest.raises(ValueError, match="no kernel"):
        attention.attention_bwd(q, q, q, q, None, q, q, 1)


@pytest.mark.parametrize("T", [8, 12, 128])
@pytest.mark.parametrize("H,nh", [(64, 1), (768, 12), (48, 4), (20, 4), (30, 4)])
def test_supported_matches_jax(T, H, nh):
    assert attention.supported(T, H, nh) == jattn.supported(T, H, nh)
