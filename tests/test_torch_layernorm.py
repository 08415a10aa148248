"""The port's LayerNorm (``ops/kernels/layernorm.py``) on the CPU: the
plain forward against the JAX package's Pallas forward ``_call_fwd`` in
interpret mode (y, mean, rstd) and against ``torch.nn.LayerNorm``; the
vjp of ``fused_layernorm`` (dx, dgamma, dbeta, through the plain
backward) against JAX ``fused_layernorm(..., interpret=True)``'s; and
the wrappers' contract, the forward's route rule and the layout of its
outputs. The kernels themselves (the forward in CUDA C++, the backward in
Triton) are held to the plain versions on the card by ``chip_smoke.py``
and ``tests/test_torch_kernels_cuda.py``.

Tolerance: rtol = atol = 1e-5 (plain version of a kernel)."""

import jax
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


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(4, 7, 128), (513, 256), (3, 100)])
def test_vjp_matches_pallas(shape, dtype):
    x, scale, bias = _inputs(shape, seed=2)
    dy = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    xj = jnp.asarray(x, jdt)
    y, vjp = jax.vjp(lambda a, s, b: jln.fused_layernorm(a, s, b, EPS, True),
                     xj, jnp.asarray(scale), jnp.asarray(bias))
    want = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(np.array(xj, np.float32)).to(tdt).requires_grad_(True)
    st, bt = (torch.from_numpy(a).requires_grad_(True) for a in (scale, bias))
    got = layernorm.fused_layernorm(xt, st, bt, EPS)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), **TOL)
    got.backward(torch.from_numpy(dy))
    assert xt.grad.dtype == tdt
    tol = TOL if dtype == "f32" else dict(rtol=1e-2, atol=1e-2)  # dx rounded to bf16
    np.testing.assert_allclose(xt.grad.float().numpy(), np.asarray(want[0], np.float32), err_msg="dx", **tol)
    for name, g, w in (("dgamma", st.grad, want[1]), ("dbeta", bt.grad, want[2])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, rtol=1e-5, atol=1e-4)


def test_bwd_plain_matches_autograd_of_torch_layernorm():
    x, scale, bias = _inputs((64, 48), seed=4)
    dy = torch.randn(64, 48, generator=torch.Generator().manual_seed(1))
    xt = torch.from_numpy(x).requires_grad_(True)
    ln = torch.nn.LayerNorm(48, eps=EPS)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
    ln(xt).backward(dy)
    _, mean, rstd = layernorm.layernorm_fwd(torch.from_numpy(x), ln.weight, ln.bias, EPS)
    layernorm.bwd_launches = 0
    dx, dgamma, dbeta = layernorm.layernorm_bwd(dy, torch.from_numpy(x), mean, rstd, ln.weight, ln.bias)
    assert layernorm.bwd_launches == 0
    for g, w in ((dx, xt.grad), (dgamma, ln.weight.grad), (dbeta, ln.bias.grad)):
        np.testing.assert_allclose(g.detach().numpy(), w.numpy(), rtol=1e-4, atol=1e-5)


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
    with pytest.raises(ValueError, match="no kernel"):
        layernorm.layernorm_bwd(x, x, x[:, :1], x[:, :1], x[0], x[0])


F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16


@pytest.mark.parametrize("d,x_dtype,w_dtype,b_dtype,aligned,route", [
    (768, F32, F32, F32, True, "warp"),     # BERT-base, f32 and bf16 compute
    (768, BF16, F32, F32, True, "warp"),
    (768, F16, F32, F32, True, "warp"),
    (1024, F32, F32, F32, True, "warp"),    # the widest row 32 lanes hold
    (1028, F32, F32, F32, True, "block"),
    (4, F32, F32, F32, True, "warp"),
    (1000, F32, F32, F32, True, "warp"),    # whole 16-byte pieces of f32 ...
    (1000, BF16, F32, F32, True, "warp"),   # ... and of bf16 (125 pieces of 8)
    (1004, BF16, F32, F32, True, "block"),  # 4 over a multiple of 8
    (100, BF16, F32, F32, True, "block"),
    (100, F32, F32, F32, True, "warp"),
    (770, F32, F32, F32, True, "block"),
    (4096, F32, F32, F32, True, "block"),
    (768, BF16, BF16, BF16, True, "block"),  # y would be bf16
    (768, F32, F32, BF16, True, "block"),
    (768, F32, F16, F32, True, "block"),
    (768, F32, F32, F32, False, "block"),   # a pointer off a 16-byte boundary
])
def test_forward_route_rule(d, x_dtype, w_dtype, b_dtype, aligned, route):
    assert layernorm.fwd_route(d, x_dtype, w_dtype, b_dtype, aligned) == route
    if aligned:
        assert layernorm.fwd_route(d, x_dtype, w_dtype, b_dtype) == route


def test_forward_codes_pack_dtypes_and_route():
    assert layernorm.fwd_codes(F32, F32, F32, "warp") == 1 << 8
    assert layernorm.fwd_codes(F32, F32, F32, "block") == 0
    # x bf16 (1), scale bf16 (1), bias f16 (2), y = promote(bf16, bf16) = bf16 (1)
    assert layernorm.fwd_codes(BF16, BF16, F16, "block") == 1 | 1 << 2 | 2 << 4 | 1 << 6
    # y = promote(f16, bf16) = f32 (0)
    assert layernorm.fwd_codes(F16, BF16, F32, "block") == 2 | 1 << 2


@pytest.mark.parametrize("x_dtype,w_dtype", [(F32, F32), (BF16, F32), (BF16, BF16), (F16, BF16)])
@pytest.mark.parametrize("n", [1, 5, 1024])
def test_forward_outputs_are_what_the_backward_takes(n, x_dtype, w_dtype):
    """mean and rstd are the halves of one (2, N, 1) allocation: each a
    contiguous (N, 1) f32 tensor, as ``layernorm_bwd`` requires, the rstds
    N floats after the means, as the C entry point assumes."""
    x = torch.zeros((n, 48), dtype=x_dtype)
    y, mean, rstd = layernorm._fwd_outputs(x, torch.ones(48, dtype=w_dtype))
    assert y.shape == x.shape and y.is_contiguous() and y.dtype == torch.promote_types(x_dtype, w_dtype)
    for t in (mean, rstd):
        assert t.shape == (n, 1) and t.dtype == torch.float32 and t.is_contiguous()
    assert rstd.data_ptr() - mean.data_ptr() == 4 * n
    assert mean.untyped_storage().data_ptr() == rstd.untyped_storage().data_ptr()
    assert y.untyped_storage().data_ptr() != mean.untyped_storage().data_ptr()
