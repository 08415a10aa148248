"""The v2 engine with a ModifiedResNet CLIP, and a batch split over ranks.

Two engine steps with the tiny VQGAN and a tiny ResNet CLIP (stage depths
(1, 1, 1, 1), 64 px, so the cutouts are 64 px) against the JAX
package's engine on the CPU: the same weights (the VQGAN flax draws there,
the CLIP of ``tests.test_torch_clip_resnet.seeded_clip_state``, each
carried over by ``convert``), the same latent, and JAX's cutout draws
replayed (``tests.test_torch_cutouts.jax_draws``), at the tolerances of
``tests/test_torch_v2_engine.py``.

Then the split itself, which needs no process group: engines built with
``shard=(rank, 2)`` step their halves of a batch of 4 from the same
generators, and together give what one engine gives over the whole
batch (losses rtol = atol = 1e-5, the latent rtol 1e-5 and atol 1e-6:
the same arithmetic on fewer rows, on one CPU thread).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagegenerator_tpu.v2 import engine as jengine
from imagegenerator_tpu.v2.clip import CLIPConfig as JCLIPConfig
from imagegenerator_tpu.v2.vqgan import VQGANConfig as JVQGANConfig
from imagegenerator_tpu.v2.vqgan import VQModel as JVQModel
from imagegenerator_tpu_torch import convert
from imagegenerator_tpu_torch.v2 import engine as tengine
from imagegenerator_tpu_torch.v2.clip import CLIPConfig
from imagegenerator_tpu_torch.v2.vqgan import VQGANConfig
from tests.test_torch_clip_resnet import CONFIGS, seeded_clip_state
from tests.test_torch_cutouts import jax_draws
from tests.test_torch_v2_engine import _latents_close, _prompts, _t

CUTN = 4
RN = CONFIGS["1111_64px"]


@pytest.fixture(scope="module")
def weights():
    """The VQGAN of ``tests/test_torch_v2_engine.py`` (flax's init from
    key 0) and the seeded ResNet CLIP, as ``state_dict``s."""
    vq_cfg = JVQGANConfig.tiny()
    vq_params = jax.jit(JVQModel(vq_cfg).init)(
        jax.random.key(0), jnp.zeros((1, vq_cfg.resolution, vq_cfg.resolution, 3)))["params"]
    vq_sd = convert.v2_vqgan_from_flax(jax.tree.map(np.asarray, vq_params), VQGANConfig.tiny())
    return vq_sd, seeded_clip_state(CLIPConfig(**RN), seed=3)


def _engine(weights, **kw):
    vq_sd, clip_sd = weights
    return tengine.GenerateEngine(VQGANConfig.tiny(), CLIPConfig(**RN), vq_sd, clip_sd, cutn=CUTN,
                                  step_size=0.1, warp_kernel=False, device="cpu", **kw)


def test_two_steps_with_a_resnet_clip_match_the_jax_engine(weights):
    vq_sd, clip_sd = weights
    jeng = jengine.GenerateEngine(
        vqgan_config=JVQGANConfig.tiny(), clip_config=JCLIPConfig(**RN),
        vqgan_params=convert.v2_vqgan_to_flax(vq_sd, VQGANConfig.tiny()),
        clip_params=convert.v2_clip_to_flax(clip_sd, CLIPConfig(**RN)), cutn=CUTN, step_size=0.1)
    port = _engine(weights)
    assert port.make_cutouts.cut_size == 64
    z = np.asarray(jeng.random_token_latent(jax.random.key(2), 1, 2, 2))  # a copy: step donates its state
    jstate, state = jeng.init_state(jnp.asarray(z)), port.init_state(_t(z))
    embeds, w, s = _prompts(RN["embed_dim"])
    for i in range(2):
        key = jax.random.fold_in(jax.random.key(3), i)
        jstate, jlosses = jeng.step(jstate, key, jnp.asarray(embeds), jnp.asarray(w), jnp.asarray(s))
        state, losses = port.step(state, None, _t(embeds), _t(w), _t(s),
                                  draws=jax_draws(key, CUTN, 1, RN["image_resolution"]))
        np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-4, atol=1e-4)
        _latents_close(state.z.detach().numpy(), np.asarray(jstate.z))
    count, mu, nu = jax.tree.leaves(jstate.opt_state)
    assert state.count == int(count) == 2
    for got, want in zip(state.moments(), (mu, nu)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


@pytest.fixture
def one_thread():
    """The CPU's kernels on one thread, where their per-row results do
    not depend on the batch around the row (on several threads a
    convolution's split does, and Adam's second step can turn such a
    rounding difference into 4e-5 of z)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_two_shards_step_what_one_engine_steps(weights, one_thread):
    whole = _engine(weights)
    shards = [_engine(weights, shard=(r, 2)) for r in range(2)]
    z = whole.random_token_latent(torch.Generator().manual_seed(0), 4, 2, 2)
    rng = np.random.default_rng(1)
    prompts = (rng.normal(size=(4, 2, RN["embed_dim"])).astype(np.float32),
               np.array([[1.0, -0.5], [0.7, 0.0], [1.0, 0.0], [0.3, 2.0]], np.float32),
               np.array([[-np.inf, 0.3], [-np.inf, -np.inf], [0.1, -np.inf], [-np.inf, -np.inf]], np.float32))
    state = whole.init_state(z)
    state, want = whole.chain(state, 2, 7, *map(_t, prompts))
    got = []
    for r, engine in enumerate(shards):
        rows = slice(2 * r, 2 * r + 2)
        st, losses = engine.chain(engine.init_state(z[rows]), 2, 7, *(_t(p[rows]) for p in prompts))
        np.testing.assert_allclose(st.z.detach().numpy(), state.z.detach().numpy()[rows], rtol=1e-5, atol=1e-6)
        got.append(losses)
    np.testing.assert_allclose(torch.cat(got, dim=1).numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    # a shard that drew for its own rows alone would take rows 0-1's draws
    own = shards[1].make_cutouts.draw(torch.Generator().manual_seed(5), (2, 4, 4, 3))
    split = shards[1].draw(torch.Generator().manual_seed(5), z[2:])
    assert split["noise"].shape == own["noise"].shape and not torch.equal(split["noise"], own["noise"])
    full = whole.draw(torch.Generator().manual_seed(5), z)
    assert torch.equal(split["noise"], full["noise"][2 * CUTN:])
    assert torch.equal(split["geometry"]["corner_u"], full["geometry"]["corner_u"][2 * CUTN:])
    assert torch.equal(split["u"], full["u"])
