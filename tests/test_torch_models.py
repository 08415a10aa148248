"""Parity of the PyTorch port's v1 models with the JAX package's, in f32
on the CPU: conditioning augmentation, the Stage-I and Stage-II
generators at tiny widths (eval mode, BatchNorm statistics redrawn), and
G1 against the golden ``tests/goldens/models.npz``.

Tolerance: rtol = atol = 1e-5."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import traverse_util

from imagegenerator_tpu.models import stackgan as jmodels
from imagegenerator_tpu.models.con_augment import ConditioningAugmentation as JCA
from imagegenerator_tpu_torch import convert
from imagegenerator_tpu_torch.models import stackgan as tmodels
from imagegenerator_tpu_torch.models.con_augment import ConditioningAugmentation
from tests.test_torch_layers import flat_variables, to_flax_variables

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "models.npz")


def test_conditioning_augmentation():
    tem = np.random.default_rng(0).standard_normal((5, 32)).astype(np.float32)
    jca = JCA(h_dim=16, c_dim=8)
    key = jax.random.key(1)
    variables = jca.init({"params": key, "noise": key}, jnp.asarray(tem))
    c_hat, mu, sigma = jca.apply(variables, jnp.asarray(tem), rngs={"noise": jax.random.key(2)})
    eps = jca.apply(
        variables, jnp.asarray(tem), rngs={"noise": jax.random.key(2)},
        method=lambda m, t: jax.random.normal(m.make_rng("noise"), (t.shape[0], m.c_dim)),
    )
    port = ConditioningAugmentation(32, 16, 8)
    convert.load_numpy(port, flat_variables(variables))
    got = port(torch.from_numpy(tem), eps=torch.from_numpy(np.array(eps)))
    for g, w in zip(got, (c_hat, mu, sigma)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)


def test_conditioning_augmentation_draws_from_the_generator():
    port = ConditioningAugmentation(32, 16, 8)
    tem = torch.randn(4, 32)
    a = port(tem, generator=torch.Generator().manual_seed(3))[0]
    b = port(tem, generator=torch.Generator().manual_seed(3))[0]
    c = port(tem, generator=torch.Generator().manual_seed(4))[0]
    assert torch.equal(a, b) and not torch.equal(a, c)


def _g1_pair(c_dim, z_dim, channels, x, seed, bn_rng):
    jg = jmodels.StageIGenerator(c_dim=c_dim, z_dim=z_dim, channels=channels)
    variables = jg.init(jax.random.key(seed), jnp.asarray(x), train=False)
    flat = flat_variables(variables, bn_rng)
    tg = tmodels.StageIGenerator(c_dim, z_dim, channels).eval()
    convert.load_numpy(tg, flat)
    want = jg.apply(to_flax_variables(flat), jnp.asarray(x), train=False)
    return tg(torch.from_numpy(np.array(x))).detach().numpy(), np.asarray(want)


def test_stage1_generator_tiny():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 28)).astype(np.float32)
    got, want = _g1_pair(16, 12, (24, 12), x, 3, rng)
    assert got.shape == (3, 16, 16, 3)
    np.testing.assert_allclose(got, want, **TOL)


def test_stage1_generator_golden():
    """G1 at the reference widths from the golden's own JAX init (the
    golden stores outputs only, tests/make_goldens.py::models_golden)."""
    x = jax.random.normal(jax.random.key(4), (2, 28))
    got, _ = _g1_pair(16, 12, (192, 96, 48, 24), x, 5, None)
    np.testing.assert_allclose(got, np.load(GOLDEN)["g1_out"], **TOL)


def test_stage2_generator_tiny():
    rng = np.random.default_rng(2)
    img = np.tanh(rng.standard_normal((2, 16, 16, 3))).astype(np.float32)
    c_hat = rng.standard_normal((2, 16)).astype(np.float32)
    geom = dict(num_residual=2, in_channels=8, feat_channels=16, res_channels=8, up_channels=(16, 8))
    jg = jmodels.StageIIGenerator(**geom)
    variables = jg.init(jax.random.key(6), jnp.asarray(img), jnp.asarray(c_hat), train=False)
    flat = flat_variables(variables, rng)
    tg = tmodels.StageIIGenerator(16, **geom).eval()
    convert.load_numpy(tg, flat)
    want = jg.apply(to_flax_variables(flat), jnp.asarray(img), jnp.asarray(c_hat), train=False)
    got = tg(torch.from_numpy(img), torch.from_numpy(c_hat)).detach().numpy()
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_stage2_generator_full_width_shapes():
    """The reference 64 -> 256 px refinement builds with the JAX
    package's parameter names and shapes (no forward: full width)."""
    jg = jmodels.StageIIGenerator()
    shapes = jax.eval_shape(
        lambda: jg.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 128)), train=False)
    )
    tg = tmodels.StageIIGenerator(device="meta")
    want = {"/".join(k): v.shape for k, v in traverse_util.flatten_dict(dict(shapes)).items()}
    sd = tg.state_dict()
    for key, flat_key, layout in convert.entries(tg):
        assert flat_key in want, flat_key
        got = tuple(sd[key].shape)
        if layout == "conv":
            got = (got[2], got[3], got[1], got[0])
        assert got == want[flat_key], (key, got, want[flat_key])
    assert len(convert.entries(tg)) == len(want)

