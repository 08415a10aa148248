"""The port's v2 engine against the JAX package's on the CPU at the tiny
configurations: the same parameters (drawn by flax, carried over by
``convert``), the same latent, and JAX's cutout draws rebuilt from its
key tree and replayed (``tests.test_torch_cutouts.jax_draws``).

Tolerances: losses rtol = atol = 1e-4 (f32 sums in another order through
two networks). The latent after a step: Adam moves a coordinate by 0.1 *
g / (|g| + 1e-8) at the first step, and the result is clamped to the
codebook's range (+-1/32 at the tiny size). Most coordinates land on the
range's corners; one whose gradient is of the order of Adam's epsilon
moves part of the way, and from the second step on the update is 0.1 *
mu / sqrt(nu) of gradients that may change sign, so a relative 1e-4 of
the gradients is up to about 1e-5 of z: atol 5e-5 (z spans +-0.03). A
coordinate whose gradient is within
rounding of zero can take the other sign; at most 1% may be off by more.
The Adam moments are held to 1e-4 of their largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagegenerator_tpu.v2 import engine as jengine
from imagegenerator_tpu.v2.clip import CLIP as JCLIP
from imagegenerator_tpu.v2.clip import CLIPConfig as JCLIPConfig
from imagegenerator_tpu.v2.vqgan import VQGANConfig as JVQGANConfig
from imagegenerator_tpu.v2.vqgan import VQModel as JVQModel
from imagegenerator_tpu_torch import convert
from imagegenerator_tpu_torch.v2 import engine as tengine
from imagegenerator_tpu_torch.v2.clip import CLIPConfig
from imagegenerator_tpu_torch.v2.vqgan import VQGANConfig
from tests.test_torch_cutouts import jax_draws

GOLDENS = __import__("os").path.join(__import__("os").path.dirname(__file__), "goldens")
CUTN = 4


@pytest.fixture(scope="module")
def engines():
    """The engines of ``tests/make_goldens.py::v2_golden`` and the port's
    with the same weights."""
    vq_cfg, clip_cfg = JVQGANConfig.tiny(), JCLIPConfig.tiny()
    vq_params = JVQModel(vq_cfg).init(
        jax.random.key(0), jnp.zeros((1, vq_cfg.resolution, vq_cfg.resolution, 3)))["params"]
    clip_params = JCLIP(clip_cfg).init(
        jax.random.key(1), jnp.zeros((1, clip_cfg.image_resolution, clip_cfg.image_resolution, 3)),
        jnp.zeros((1, clip_cfg.context_length), jnp.int32))["params"]
    jeng = jengine.GenerateEngine(vqgan_config=vq_cfg, clip_config=clip_cfg, vqgan_params=vq_params,
                                  clip_params=clip_params, cutn=CUTN, step_size=0.1)
    as_np = lambda tree: jax.tree.map(np.asarray, tree)
    port = tengine.GenerateEngine(
        VQGANConfig.tiny(), CLIPConfig.tiny(),
        convert.v2_vqgan_from_flax(as_np(vq_params), VQGANConfig.tiny()),
        convert.v2_clip_from_flax(as_np(clip_params), CLIPConfig.tiny()),
        cutn=CUTN, step_size=0.1, warp_kernel=False, device="cpu",
    )
    return jeng, port


def _prompts(embed_dim):
    return (np.full((1, 1, embed_dim), 0.1, np.float32), np.ones((1, 1), np.float32),
            np.full((1, 1), -np.inf, np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _latents_close(got, want, atol=5e-5, share=0.01):
    off = np.abs(got - want) > atol
    assert off.mean() <= share, (off.mean(), np.abs(got - want).max())


def test_two_steps_match_the_jax_engine_and_its_golden(engines):
    jeng, port = engines
    z = np.asarray(jeng.random_token_latent(jax.random.key(2), 1, 2, 2))  # a copy: step donates its state
    jstate = jeng.init_state(jnp.asarray(z))
    state = port.init_state(_t(z))
    embeds, w, s = _prompts(jeng.clip_config.embed_dim)
    for i in range(2):
        key = jax.random.fold_in(jax.random.key(3), i)
        jstate, jlosses = jeng.step(jstate, key, jnp.asarray(embeds), jnp.asarray(w), jnp.asarray(s))
        draws = jax_draws(key, CUTN, 1, jeng.clip_config.image_resolution)
        state, losses = port.step(state, None, _t(embeds), _t(w), _t(s), draws=draws)
        np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-4, atol=1e-4)
        _latents_close(state.z.detach().numpy(), np.asarray(jstate.z))
    count, mu, nu = jax.tree.leaves(jstate.opt_state)
    assert state.count == int(count) == 2 and state.step == int(jstate.step) == 2
    for got, want in zip(state.moments(), (mu, nu)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    with np.load(f"{GOLDENS}/v2_engine.npz") as golden:
        np.testing.assert_allclose(losses.numpy(), golden["losses"], rtol=1e-4, atol=1e-4)
        _latents_close(state.z.detach().numpy(), golden["z"])


def test_synth_and_inits_match_jax(engines):
    jeng, port = engines
    rng = np.random.default_rng(0)
    z = rng.normal(scale=0.02, size=(2, 4, 4, 8)).astype(np.float32)
    np.testing.assert_allclose(port.synth(_t(z)).numpy(), np.asarray(jeng.synth(jnp.asarray(z))), rtol=1e-4, atol=1e-4)
    images = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    got = port.encode_image_to_latent(images)
    want = np.asarray(jeng.encode_image_to_latent(jnp.asarray(images)))
    assert got.shape == want.shape == (2, 16, 16, 8) and got.dtype == torch.float32
    # each row is a code; the encoder's outputs differ by rounding between
    # the two, which may move a row that lies between two codes: 2%
    codebook = port.vqmodel.codebook.detach()
    assert _is_code(got, codebook).all()
    assert (got.numpy() != want).any(axis=-1).mean() <= 0.02
    tokens = np.array([[254, 7, 9, 255] + [0] * 12], np.int32)
    np.testing.assert_allclose(port.encode_text(tokens).numpy(), np.asarray(jeng.encode_text(tokens)), rtol=1e-4, atol=1e-4)
    drawn = port.random_token_latent(torch.Generator().manual_seed(0), 3, 2, 5)
    assert drawn.shape == (3, 2, 5, 8)
    assert _is_code(drawn, codebook).all()


def _is_code(rows, codebook):
    return (rows.reshape(-1, 1, codebook.shape[1]) == codebook[None]).all(dim=-1).any(dim=-1)


def _fresh(port, seed=0, batch=2):
    z = port.random_token_latent(torch.Generator().manual_seed(seed), batch, 2, 2)
    rng = np.random.default_rng(seed)
    prompts = (_t(rng.normal(size=(batch, 2, 16)).astype(np.float32)),
               _t(np.array([[1.0, -0.5], [0.7, 0.0]], np.float32)[:batch]),
               _t(np.array([[-np.inf, 0.3], [-np.inf, -np.inf]], np.float32)[:batch]))
    return port.init_state(z), prompts


def _same_state(a, b):
    assert a.step == b.step and a.count == b.count
    assert torch.equal(a.z, b.z)
    for x, y in zip(a.moments(), b.moments()):
        assert torch.equal(x, y)


def test_chain_equals_stepping_and_step_is_in_place(engines):
    _, port = engines
    a, prompts = _fresh(port)
    b = a.clone()
    a_id = a
    a, chained = port.chain(a, 3, 11, *prompts)
    assert a is a_id and chained.shape == (3, 2, 2)
    stepped = []
    for _ in range(3):
        b, losses = port.step(b, tengine.iteration_generator(11, b.step, "cpu"), *prompts)
        stepped.append(losses)
    _same_state(a, b)
    assert torch.equal(chained, torch.stack(stepped))
    other, _ = port.chain(_fresh(port)[0], 3, 12, *prompts)
    assert not torch.equal(other.z, a.z) or not torch.equal(other.moments()[0], a.moments()[0])


def test_run_calls_back_in_the_jax_engines_order(engines):
    jeng, port = engines
    for iterations, every in ((5, 2), (4, 2), (0, 3), (3, 5)):
        events = {"jax": [], "port": []}

        def hooks(side):
            log = events[side]
            return dict(
                checkin=lambda i, imgs, losses: log.append(("checkin", i, imgs.shape, losses.shape)),
                progress=lambda done, total, last: log.append(("progress", done, total, last.shape)),
                state_callback=lambda i, st: log.append(("state", i, int(st.step))),
            )

        z = np.asarray(jeng.random_token_latent(jax.random.key(2), 1, 2, 2))  # a copy: step donates its state
        embeds, w, s = _prompts(16)
        jeng.run(jeng.init_state(jnp.asarray(z)), jax.random.key(5), jnp.asarray(embeds), jnp.asarray(w), jnp.asarray(s),
                 iterations=iterations, display_freq=every, **hooks("jax"))
        port.run(port.init_state(_t(z)), 5, embeds, w, s, iterations=iterations, display_freq=every,
                 **hooks("port"))
        assert events["port"] == events["jax"], (iterations, every)
        assert events["port"], (iterations, every)


def test_resumed_run_equals_uninterrupted_one(engines, tmp_path):
    _, port = engines
    full, prompts = _fresh(port, seed=1)
    half = full.clone()
    full = port.run(full, 21, *prompts, iterations=4, display_freq=2)
    path = str(tmp_path / "s.npz")
    port.run(half, 21, *prompts, iterations=2, display_freq=2,
             state_callback=lambda i, st: tengine.save_latent_state(path, i, st))
    done, resumed = tengine.load_latent_state(path, _fresh(port, seed=1)[0])
    assert done == 2 and resumed.step == 2
    resumed = port.run(resumed, 21, *prompts, iterations=2, display_freq=2)
    _same_state(full, resumed)


def test_state_files_cross_between_the_packages(engines, tmp_path):
    jeng, port = engines
    z = np.asarray(jeng.random_token_latent(jax.random.key(2), 1, 2, 2))  # a copy: step donates its state
    embeds, w, s = _prompts(16)
    jstate = jeng.init_state(jnp.asarray(z))
    for i in range(2):
        jstate, _ = jeng.step(jstate, jax.random.fold_in(jax.random.key(3), i),
                              jnp.asarray(embeds), jnp.asarray(w), jnp.asarray(s))
    # a file the JAX package writes: the leaf order and dtypes, then the port reads it
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    jengine.save_latent_state(jpath, 2, jstate)
    with np.load(jpath) as d:
        assert int(d["n_leaves"]) == 5 and d["leaf_1"].dtype == np.int32 and d["leaf_4"].dtype == np.int32
        assert d["leaf_0"].shape == d["leaf_2"].shape == d["leaf_3"].shape == (1, 2, 2, 8)
        np.testing.assert_array_equal(d["leaf_0"], np.asarray(jstate.z))
    done, state = tengine.load_latent_state(jpath, port.init_state(_t(z)))
    count, mu, nu = jax.tree.leaves(jstate.opt_state)
    assert (done, state.step, state.count) == (2, 2, 2)
    np.testing.assert_array_equal(state.z.detach().numpy(), np.asarray(jstate.z))
    np.testing.assert_array_equal(state.moments()[0].numpy(), np.asarray(mu))
    np.testing.assert_array_equal(state.moments()[1].numpy(), np.asarray(nu))
    # the port's next step from it equals JAX's next step
    key = jax.random.fold_in(jax.random.key(3), 2)
    jnext, jlosses = jeng.step(jstate, key, jnp.asarray(embeds), jnp.asarray(w), jnp.asarray(s))
    state, losses = port.step(state, None, _t(embeds), _t(w), _t(s), draws=jax_draws(key, CUTN, 1, 32))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-4, atol=1e-4)
    _latents_close(state.z.detach().numpy(), np.asarray(jnext.z))
    # a file the port writes, read by the JAX package
    tengine.save_latent_state(tpath, 3, state)
    done, back = jengine.load_latent_state(tpath, jeng.init_state(jnp.asarray(z)))
    assert done == 3 and int(back.step) == 3
    for got, want in zip(jax.tree.leaves(back), state.leaves()):
        assert np.asarray(got).dtype == want.dtype
        np.testing.assert_array_equal(np.asarray(got), want)
    # and through convert's leaves
    again = convert.v2_state_from_leaves(convert.v2_state_to_leaves(state), 0.1, "cpu")
    _same_state(again, state)


def test_loading_a_state_of_another_geometry_raises(engines, tmp_path):
    _, port = engines
    state, _ = _fresh(port)
    path = str(tmp_path / "s.npz")
    tengine.save_latent_state(path, 1, state)
    with pytest.raises(ValueError, match="leaf 0"):
        tengine.load_latent_state(path, _fresh(port, batch=1)[0])
    np.savez(path, iters_done=np.int64(1), n_leaves=np.int64(2), leaf_0=np.zeros(3), leaf_1=np.zeros(3))
    with pytest.raises(ValueError, match="2 leaves"):
        tengine.load_latent_state(path, state)


def test_pad_prompt_specs_matches_jax():
    rng = np.random.default_rng(0)
    embeds = [rng.normal(size=(16,)).astype(np.float32) for _ in range(2)]
    for args in ((embeds, [1.0, -0.5], [-np.inf, 0.2], 3), (embeds[:1], [2.0], [0.1], None), ([], [], [], None)):
        for got, want in zip(tengine.pad_prompt_specs(*args), jengine.pad_prompt_specs(*args)):
            np.testing.assert_array_equal(got, want)


def test_the_engine_is_an_entry_point_and_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tengine.GenerateEngine(VQGANConfig.tiny(), CLIPConfig.tiny())
