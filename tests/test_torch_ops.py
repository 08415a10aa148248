"""The port's non-kernel custom ops on the CPU: ``ops/gelu.py``'s
output-recovered backward against JAX's ``gelu_exact_output_bwd`` (f32
and bf16), and ``ops/dropout.py``'s dropout and bits-dropout: keep rates,
rescaling, generator draws and errors. The dropout bitstreams are
PyTorch's and cannot match threefry, so those tests read statistics.

Tolerance: GELU rtol = atol = 1e-6 in f32 (the same formula in the same
order); one bf16 rounding in bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagegenerator_tpu.ops import dropout as jdropout
from imagegenerator_tpu.ops import gelu as jgelu
from imagegenerator_tpu_torch.ops import dropout, gelu

torch.set_num_threads(2)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gelu_output_bwd_matches_jax(dtype):
    rng = np.random.default_rng(0)
    y = np.concatenate([rng.standard_normal(4000) * 3, rng.uniform(-0.05, 0.05, 1000),
                        [0.0, 1e-8, -1e-8, 0.03125, -0.03125, 8.0, -8.0]]).astype(np.float32)
    g = rng.standard_normal(y.shape).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    yj = jnp.asarray(y, jdt)
    h, vjp = jax.vjp(jgelu.gelu_exact_output_bwd, yj)
    (want,) = vjp(jnp.asarray(g, jdt))
    yt = torch.from_numpy(np.array(yj, np.float32)).to(tdt).requires_grad_(True)
    got = gelu.gelu_exact_output_bwd(yt)
    got.backward(torch.from_numpy(np.array(jnp.asarray(g, jdt), np.float32)).to(tdt))
    assert got.dtype == yt.grad.dtype == tdt
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "f32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(h, np.float32), **tol)
    np.testing.assert_allclose(yt.grad.float().numpy(), np.asarray(want, np.float32), **tol)


def test_gelu_output_bwd_is_the_exact_derivative():
    y = torch.linspace(-6, 6, 2001, dtype=torch.float64).float().requires_grad_(True)
    gelu.gelu_exact_output_bwd(y).sum().backward()
    ref = y.detach().double().requires_grad_(True)
    torch.nn.functional.gelu(ref).sum().backward()
    np.testing.assert_allclose(y.grad.numpy(), ref.grad.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_rate_and_scaling(rate):
    x = torch.ones(200_000)
    y = dropout.dropout(x, rate, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.005
    assert torch.allclose(y[kept], torch.tensor(1 / (1 - rate)))
    assert abs(y.mean().item() - 1.0) < 0.01


def test_dropout_divides_by_the_keep_prob_in_x_dtype():
    """As flax does: a bf16 x is divided by keep_prob rounded to bf16."""
    x = torch.ones(1000, dtype=torch.bfloat16)
    y = dropout.dropout(x, 0.1, torch.Generator().manual_seed(0))
    want = np.asarray(jnp.ones((), jnp.bfloat16) / jnp.asarray(0.9, jnp.bfloat16), np.float32)
    assert y.dtype == torch.bfloat16
    assert set(y.float().unique().tolist()) == {0.0, float(want)}


def test_dropout_draws_from_the_generator():
    x = torch.randn(64, 64)
    a = dropout.dropout(x, 0.3, torch.Generator().manual_seed(1))
    b = dropout.dropout(x, 0.3, torch.Generator().manual_seed(1))
    c = dropout.dropout(x, 0.3, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert dropout.dropout(x, 0.0) is x
    assert not dropout.dropout(x, 1.0).any()


@pytest.mark.parametrize("bits", [8, 16, 32])
@pytest.mark.parametrize("rate", [0.1, 0.25])
def test_bits_dropout_quantised_rate_and_exact_rescale(rate, bits):
    n = 1 << bits
    thr = int(round(rate * n))
    keep_prob = 1.0 - thr / n
    x = torch.ones(400_000, dtype=torch.float64)
    y = dropout.bits_dropout(x, rate, bits, torch.Generator().manual_seed(3))
    kept = y != 0
    assert abs(kept.double().mean().item() - keep_prob) < 0.004
    assert torch.equal(y[kept], torch.full_like(y[kept], 1.0 / keep_prob))
    # the same quantisation as JAX's
    want = jdropout.bits_dropout(jnp.ones((4,)), jax.random.key(0), rate, bits)
    kept_j = np.asarray(want)[np.asarray(want) != 0]
    np.testing.assert_allclose(kept_j, np.float32(1.0 / keep_prob), rtol=1e-7)


@pytest.mark.parametrize("rate,bits", [(1e-6, 8), (0.999, 8), (-0.1, 16), (1.0, 16)])
def test_bits_dropout_refuses_what_jax_refuses(rate, bits):
    with pytest.raises(ValueError):
        jdropout.bits_dropout(jnp.ones((4,)), jax.random.key(0), rate, bits)
    with pytest.raises(ValueError):
        dropout.bits_dropout(torch.ones(4), rate, bits)


def test_bits_dropout_rate_zero_is_identity_and_bits_must_be_known():
    x = torch.randn(8)
    assert dropout.bits_dropout(x, 0.0, 16) is x
    with pytest.raises(KeyError):
        dropout.bits_dropout(x, 0.1, 12)
