"""Parity of the PyTorch port's layers with the JAX package's, in f32 on
the CPU: the same flax-initialised parameters, converted by
``imagegenerator_tpu_torch.convert``, and the same numpy inputs.

Tolerance: rtol = atol = 1e-5 (single layers; the two sides sum in
different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from imagegenerator_tpu.models import stackgan as jmodels
from imagegenerator_tpu.ops import layers as jlayers
from imagegenerator_tpu_torch import convert
from imagegenerator_tpu_torch.models import stackgan as tmodels
from imagegenerator_tpu_torch.ops import layers as tlayers

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def flat_variables(variables, rng=None):
    """flax variables -> the flat ``params/...``/``batch_stats/...`` dict;
    with ``rng``, BatchNorm scale/bias/mean/var are redrawn so eval mode
    is not the identity."""
    flat = {}
    for path, leaf in traverse_util.flatten_dict(dict(variables)).items():
        a = np.asarray(leaf)
        if rng is not None and "bn" in path:
            if path[-1] == "var":
                a = rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
            else:
                a = (a + 0.3 * rng.standard_normal(a.shape)).astype(np.float32)
        flat["/".join(path)] = a
    return flat


def to_flax_variables(flat):
    return traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _port_pair(jmod, tmod, x_nhwc, seed, **init_kw):
    """Init ``jmod`` on x, load its (BN-randomised) variables into
    ``tmod``; returns the flax variables both now hold."""
    variables = jmod.init(jax.random.key(seed), jnp.asarray(x_nhwc), **init_kw)
    flat = flat_variables(variables, np.random.default_rng(seed))
    convert.load_numpy(tmod, flat)
    return to_flax_variables(flat)


@pytest.mark.parametrize(
    "in_ch,out_ch,k,s,p,bias",
    [(5, 7, 3, 1, 1, True), (3, 8, 4, 2, 1, True), (6, 4, 4, 2, 1, False), (9, 5, 1, 1, 0, True)],
)
def test_conv2d(in_ch, out_ch, k, s, p, bias):
    x = np.random.default_rng(1).standard_normal((2, 12, 12, in_ch)).astype(np.float32)
    jmod = jlayers.Conv2d(out_ch, k, s, p, use_bias=bias)
    tmod = tlayers.Conv2d(in_ch, out_ch, k, s, p, use_bias=bias)
    variables = _port_pair(jmod, tmod, x, 0)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    np.testing.assert_allclose(nhwc(tmod(nchw(x))), want, **TOL)


@pytest.mark.parametrize(
    "in_ch,out_ch,k,s,p,hw",
    [(6, 4, 4, 2, 1, 8), (10, 6, 4, 1, 0, 1), (7, 3, 4, 2, 1, 5), (4, 5, 3, 1, 1, 6)],
)
def test_conv_transpose2d(in_ch, out_ch, k, s, p, hw):
    x = np.random.default_rng(2).standard_normal((2, hw, hw, in_ch)).astype(np.float32)
    jmod = jlayers.ConvTranspose2d(out_ch, k, s, p)
    tmod = tlayers.ConvTranspose2d(in_ch, out_ch, k, s, p)
    variables = _port_pair(jmod, tmod, x, 1)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    got = nhwc(tmod(nchw(x)))
    assert got.shape == (2, (hw - 1) * s - 2 * p + k, (hw - 1) * s - 2 * p + k, out_ch)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("bias", [True, False])
def test_dense(bias):
    x = np.random.default_rng(3).standard_normal((4, 3, 24)).astype(np.float32)
    jmod = jlayers.Dense(10, use_bias=bias)
    tmod = tlayers.Dense(24, 10, use_bias=bias)
    variables = _port_pair(jmod, tmod, x, 2)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    np.testing.assert_allclose(tmod(torch.from_numpy(x)).detach().numpy(), want, **TOL)


def test_dense_computes_in_its_dtype_or_the_input_dtype():
    x = torch.randn(3, 8)
    assert tlayers.Dense(8, 4)(x).dtype == torch.float32
    assert tlayers.Dense(8, 4)(x.bfloat16()).dtype == torch.bfloat16
    assert tlayers.Dense(8, 4, dtype=torch.bfloat16)(x).dtype == torch.bfloat16


def test_batchnorm_eval():
    x = np.random.default_rng(4).standard_normal((3, 5, 5, 6)).astype(np.float32)
    jmod = jlayers.BatchNorm(use_running_average=True)
    tmod = tlayers.BatchNorm(6).eval()
    variables = _port_pair(jmod, tmod, x, 3)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    np.testing.assert_allclose(nhwc(tmod(nchw(x))), want, **TOL)


def test_batchnorm_train_matches_flax_stats():
    """Training mode normalises with the biased batch variance and folds
    that variance (not torch's unbiased one) into running_var at
    momentum 0.1 — flax's rule."""
    x = (np.random.default_rng(5).standard_normal((4, 6, 6, 3)) * 2 + 1).astype(np.float32)
    jmod = jlayers.BatchNorm(use_running_average=False)
    tmod = tlayers.BatchNorm(3).train()
    variables = _port_pair(jmod, tmod, x, 4)
    want, mut = jmod.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    np.testing.assert_allclose(nhwc(tmod(nchw(x))), np.asarray(want), **TOL)
    stats = mut["batch_stats"]["bn"]
    np.testing.assert_allclose(tmod.running_mean.numpy(), np.asarray(stats["mean"]), **TOL)
    np.testing.assert_allclose(tmod.running_var.numpy(), np.asarray(stats["var"]), **TOL)


def grid_input(shape, shift, step, seed):
    """``shift`` plus N(0, 0.5) rounded to multiples of ``step``: with a
    coarse enough step every sum of x and x^2 is exact in f32, so the
    result does not depend on the order in which a framework sums."""
    z = np.random.default_rng(seed).standard_normal(shape) * 0.5
    return (shift + np.round(z / step) * step).astype(np.float32)


@pytest.mark.parametrize("shift,step", [(0.0, None), (30.0, 0.5)])
def test_batchnorm_train_uses_flax_fast_variance(shift, step):
    """flax's nn.BatchNorm takes var = max(E[x^2] - E[x]^2, 0) in f32
    (use_fast_variance). At shift 30 that formula cancels 900 against
    900, so its f32 result depends on the summation order (XLA on the CPU
    sums rows in order, torch in blocks): the case holds the formula on
    input whose sums are exact, where the two-pass variance the port used
    before reads 2.5e-4 max abs y difference."""
    shape = (8, 16, 16, 64)
    if step is None:
        x = (np.random.default_rng(8).standard_normal(shape) * 0.5 + shift).astype(np.float32)
    else:
        x = grid_input(shape, shift, step, 8)
    jmod = jlayers.BatchNorm(use_running_average=False)
    tmod = tlayers.BatchNorm(64).train()
    variables = _port_pair(jmod, tmod, x, 7)
    want, mut = jmod.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    np.testing.assert_allclose(nhwc(tmod(nchw(x))), np.asarray(want), **TOL)
    stats = mut["batch_stats"]["bn"]
    np.testing.assert_allclose(tmod.running_mean.numpy(), np.asarray(stats["mean"]), **TOL)
    np.testing.assert_allclose(tmod.running_var.numpy(), np.asarray(stats["var"]), **TOL)


@pytest.mark.parametrize("dtype,want", [(None, torch.float32), (torch.bfloat16, torch.bfloat16)])
def test_batchnorm_output_dtype(dtype, want):
    bn = tlayers.BatchNorm(4, dtype=dtype).eval()
    assert bn(torch.randn(2, 4, 3, 3).bfloat16()).dtype == want


@pytest.mark.parametrize(
    "block,geom",
    [("UpBlock", dict(kernel_size=4, stride=2, padding=1)),
     ("UpBlock", dict(kernel_size=4, stride=1, padding=0)),
     ("DownBlock", {})],
)
def test_blocks(block, geom):
    hw = 1 if geom.get("stride") == 1 else 8
    x = np.random.default_rng(6).standard_normal((2, hw, hw, 6)).astype(np.float32)
    jmod = getattr(jlayers, block)(5, **geom)
    tmod = getattr(tlayers, block)(6, 5, **geom).eval()
    variables = _port_pair(jmod, tmod, x, 5, train=False)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), train=False))
    np.testing.assert_allclose(nhwc(tmod(nchw(x))), want, **TOL)


def test_residual_block():
    x = np.random.default_rng(7).standard_normal((2, 4, 4, 10)).astype(np.float32)
    jmod = jmodels.ResidualBlock(6)
    tmod = tmodels.ResidualBlock(10, 6).eval()
    variables = _port_pair(jmod, tmod, x, 6, train=False)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), train=False))
    np.testing.assert_allclose(nhwc(tmod(nchw(x))), want, **TOL)


@pytest.mark.parametrize(
    "layer,fan_in",
    [(lambda g: tlayers.Conv2d(16, 32, 3, generator=g), 16 * 9),
     (lambda g: tlayers.ConvTranspose2d(32, 16, 4, generator=g), 16 * 16),
     (lambda g: tlayers.Dense(64, 48, generator=g), 64)],
)
def test_torch_default_init_law(layer, fan_in):
    """Weights and biases are U(+-1/sqrt(fan_in)), with a transposed
    conv's fan-in taken over its output channels; the generator decides
    the draw."""
    mod = layer(torch.Generator().manual_seed(0))
    bound = 1.0 / np.sqrt(fan_in)
    w = mod.weight.detach().numpy()
    assert np.abs(w).max() <= bound and np.abs(w).max() > 0.95 * bound
    assert abs(w.std() - bound / np.sqrt(3)) < 0.05 * bound
    assert np.abs(mod.bias.detach().numpy()).max() <= bound
    again = layer(torch.Generator().manual_seed(0))
    assert torch.equal(mod.weight, again.weight)
