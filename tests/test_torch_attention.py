"""The port's attention forward (``ops/kernels/attention.py``) on the CPU:
its plain version against the JAX package's Pallas forward
``_pallas_fwd`` run in interpret mode, output by output (o, m, l); and
the wrapper's contract (a CPU tensor takes the plain version and counts
no launch). The CUDA kernel itself is held to the plain version on the
card by ``chip_smoke.py``.

Tolerance: rtol = atol = 1e-5 (plain version of a kernel)."""

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


def test_dropout_is_not_ported():
    q = torch.zeros(1, 8, 64)
    with pytest.raises(NotImplementedError):
        attention.fused_attention(q, q, q, None, num_heads=1, dropout_rate=0.1)


def test_no_kernel_for_other_devices():
    q = torch.zeros(1, 8, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        attention.attention_fwd(q, q, q, None, 1)


@pytest.mark.parametrize("T", [8, 12, 128])
@pytest.mark.parametrize("H,nh", [(64, 1), (768, 12), (48, 4), (20, 4), (30, 4)])
def test_supported_matches_jax(T, H, nh):
    assert attention.supported(T, H, nh) == jattn.supported(T, H, nh)
