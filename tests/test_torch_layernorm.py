"""The port's LayerNorm forward (``ops/kernels/layernorm.py``) on the CPU:
its plain version against the JAX package's Pallas forward ``_call_fwd``
in interpret mode (y, mean, rstd) and against ``torch.nn.LayerNorm``;
and the wrapper's contract. The Triton kernel itself is held to the
plain version on the card by ``chip_smoke.py``.

Tolerance: rtol = atol = 1e-5 (plain version of a kernel)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagegenerator_tpu.ops.pallas import layernorm as jln
from imagegenerator_tpu_torch.ops.kernels import layernorm

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
EPS = 1e-12


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = (rng.standard_normal(shape) * 3 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(4, 7, 128), (513, 256), (256, 768)])
def test_plain_matches_pallas_forward(shape, dtype):
    x, scale, bias = _inputs(shape)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    x2 = x.reshape(-1, shape[-1])
    want = jln._call_fwd(jnp.asarray(x2, jdt), jnp.asarray(scale), jnp.asarray(bias), EPS, True)
    # the bf16 input both sides see: the same rounded values
    xt = torch.from_numpy(np.array(jnp.asarray(x2, jdt), np.float32)).to(tdt)
    got = layernorm.layernorm_reference(xt, torch.from_numpy(scale), torch.from_numpy(bias), EPS)
    assert got[0].dtype == torch.float32  # promote(x, f32 scale)
    for name, g, w in zip(("y", "mean", "rstd"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32), err_msg=name, **TOL)


@pytest.mark.parametrize("shape", [(4, 7, 128), (513, 256), (256, 768)])
def test_plain_matches_torch_layernorm(shape):
    x, scale, bias = _inputs(shape, seed=1)
    ln = torch.nn.LayerNorm(shape[-1], eps=EPS)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
        want = ln(torch.from_numpy(x))
    got = layernorm.fused_layernorm(torch.from_numpy(x), ln.weight, ln.bias, EPS)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), **TOL)


def test_output_dtype_is_promoted():
    x = torch.randn(6, 32).bfloat16()
    assert layernorm.fused_layernorm(x, torch.ones(32), torch.zeros(32)).dtype == torch.float32
    bf = torch.ones(32).bfloat16()
    assert layernorm.fused_layernorm(x, bf, bf * 0).dtype == torch.bfloat16


def test_variance_is_two_pass():
    """A large offset with a tiny spread: E[x^2] - E[x]^2 cancels to 0 in
    f32, mean((x - mean)^2) keeps the spread."""
    x = torch.full((2, 256), 1e4) + torch.linspace(-1e-2, 1e-2, 256)
    y, _, rstd = layernorm.layernorm_reference(x, torch.ones(256), torch.zeros(256), 1e-12)
    assert torch.isfinite(rstd).all() and rstd.max() < 1e4
    assert y.std() > 0.5


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    x, scale, bias = map(torch.from_numpy, _inputs((3, 5, 64)))
    layernorm.launches = 0
    y = layernorm.fused_layernorm(x, scale, bias, EPS)
    assert layernorm.launches == 0
    want = layernorm.layernorm_reference(x.reshape(15, 64), scale, bias, EPS)[0]
    assert torch.equal(y, want.reshape(3, 5, 64))


def test_no_kernel_for_other_devices():
    x = torch.zeros(4, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        layernorm.layernorm_fwd(x, x[0], x[0], EPS)
