"""The port's stage-2 training step (``Stage2System.train_step``) against
the JAX package's ``stage2.make_train_step``, in f32 on the CPU, at
``Stage2Config.tiny(n_critic=2)``: the same flax initial state converted
by ``imagegenerator_tpu_torch.convert``, the same batch, and the JAX key
tree's noise (permutation; per critic iteration CA1 eps, z, CA2 eps, GP
eps) replayed into the port, on the tokens route and the ``tem`` route,
with f32 and uint8 images. With ``fused_attention`` and ``fused_ln`` on,
the JAX side runs its Pallas kernels in interpret mode and the port its
kernels' plain versions.

Each step starts both sides from the same state (the second step from the
port's state after the first, converted back to JAX). Tolerances are the
stage-1 step test's (``tests/test_torch_stage1_step.py``): metrics and
BatchNorm statistics rtol = atol = 1e-4, the optimizers' moments and the
parameters by ``assert_state_close``. The frozen stack is held bit-equal.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagegenerator_tpu.models.bert import BertConfig as JBertConfig
from imagegenerator_tpu.train import stage2 as js2
from imagegenerator_tpu_torch import convert
from imagegenerator_tpu_torch.models.bert import BertConfig
from imagegenerator_tpu_torch.models.stackgan import StageIIDiscriminator
from imagegenerator_tpu_torch.train import stage2 as ts2
from tests.test_torch_layers import flat_variables, to_flax_variables
from tests.test_torch_sample import _eps
from tests.test_torch_stage1_step import (
    TOL,
    _metrics_close,
    assert_state_close,
    jax_flat,
    jax_state_from_flat,
)

torch.set_num_threads(2)
B = 4
FIELDS = ("frozen_params", "frozen_gen_stats", "params", "batch_stats")
FROZEN = ("frozen_params/", "frozen_gen_stats/")
CASES = {
    # text route, attention and LayerNorm route, image dtype, kl_mode
    "tokens_f32": dict(route="tokens", fused=False, uint8=False, kw={}),
    "tokens_fused_uint8": dict(route="tokens", fused=True, uint8=True, kw=dict(kl_mode="faithful")),
    "tem_uint8": dict(route="tem", fused=False, uint8=True, kw={}),
    # batch seed 5: at seed 0 one input of a G2 ReLU lies 1.4e-6 from 0 and
    # the two sides' roundings take it to different sides of the kink
    "tem_f32": dict(route="tem", fused=False, uint8=False, kw={}, seed=5),
}


def _configs(kw, fused):
    extra = dict(fused_attention=fused, fused_ln=fused)
    jcfg = js2.Stage2Config.tiny(n_critic=2, bert=dataclasses.replace(JBertConfig.tiny(), **extra), **kw)
    tcfg = ts2.Stage2Config.tiny(n_critic=2, bert=dataclasses.replace(BertConfig.tiny(), **extra), **kw)
    return jcfg, tcfg


def _batch(cfg, route, uint8, seed=0):
    rng = np.random.default_rng(seed)
    T, r = cfg.seq_len, cfg.resolution
    if uint8:
        batch = {"image": rng.integers(0, 256, (B, r, r, 3)).astype(np.uint8)}
    else:
        batch = {"image": rng.uniform(-1, 1, (B, r, r, 3)).astype(np.float32)}
    if route == "tem":
        batch["tem"] = rng.standard_normal((B, cfg.tem_size)).astype(np.float32)
        return batch
    mask = np.ones((B, T), np.int32)
    mask[1, T // 2:] = 0
    mask[3, 3:] = 0
    batch["input_ids"] = rng.integers(0, cfg.bert.vocab_size, (B, T)).astype(np.int32)
    batch["attention_mask"] = mask
    return batch


def jax_noise(system, state, key, n=B):
    """The draws of the JAX step's key tree (``stage2.py:350-352, 402``):
    perm, then per critic iteration CA1 eps, z, CA2 eps and GP eps."""
    c = system.config
    k_perm, k_loop = jax.random.split(key)
    noise = {"perm": jax.random.permutation(k_perm, n), "ca1_eps": [], "z": [], "ca2_eps": [], "gp_eps": []}
    tem = jnp.zeros((n, c.tem_size))
    for it_key in jax.random.split(k_loop, c.n_critic):
        k_ca1, k_z, k_ca2, k_gp = jax.random.split(it_key, 4)
        noise["ca1_eps"].append(_eps(system.con_augment_1, state.frozen_params["con_augment_1"], tem, k_ca1))
        noise["z"].append(jax.random.normal(k_z, (n, c.z_dim), jnp.float32))
        noise["ca2_eps"].append(_eps(system.con_augment_2, state.params["con_augment_2"], tem, k_ca2))
        noise["gp_eps"].append(jax.random.uniform(k_gp, (n, 1, 1, 1), dtype=jnp.float32))
    return {k: torch.from_numpy(np.array(v)) for k, v in noise.items()}


def _frozen(flat):
    return {k: v for k, v in flat.items() if k.startswith(FROZEN)}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_steps():
    """One compiled JAX step per (config, route) (compiles are most of
    the time)."""
    cache = {}

    def get(name):
        if name not in cache:
            jcfg, _ = _configs(CASES[name]["kw"], CASES[name]["fused"])
            system = js2.Stage2System(jcfg)
            state = jax.jit(system.init, static_argnums=1)(jax.random.key(0), B)
            cache[name] = system, state, js2.make_train_step(system, donate=False)
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(CASES))
def test_two_steps_match_jax(name, jax_steps):
    case = CASES[name]
    system, state, step = jax_steps(name)
    _, tcfg = _configs(case["kw"], case["fused"])
    port = convert.stage2_from_numpy(jax_flat(state, FIELDS), tcfg, "cpu")
    batch = _batch(tcfg, case["route"], case["uint8"], case.get("seed", 0))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    frozen = _frozen(convert.to_numpy(port))
    for i, seed in enumerate((11, 12)):
        if i:  # both sides take the second step from the port's state
            state = jax_state_from_flat(state, convert.to_numpy(port), FIELDS)
        key = jax.random.key(seed)
        noise = jax_noise(system, state, key)
        state, want = step(state, jbatch, key)
        got = port.train_step(_torch_batch(batch), noise=noise)
        _metrics_close(got, want, f"{name} step {i + 1}")
        assert_state_close(port, state, tcfg, f"{name} step {i + 1}", FIELDS)
    assert port.step == 2 and not port.training
    after = _frozen(convert.to_numpy(port))
    assert set(after) == set(frozen) and len(frozen) > 20
    for k, v in frozen.items():
        assert np.array_equal(after[k], v), f"the frozen stack moved: {k}"


def test_frozen_stack_is_untouched_by_the_optimizers():
    """No optimizer holds a frozen parameter, the frozen modules never
    enter training mode, and a step leaves them (BatchNorm statistics
    included) bit-equal while every trained module moves."""
    cfg = ts2.Stage2Config.tiny(n_critic=2)
    port = ts2.Stage2System(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    before = convert.to_numpy(port)
    modes = []
    for name in ts2.FROM_STAGE1.values():
        getattr(port, name).register_forward_pre_hook(lambda m, _: modes.append(m.training))
    port.train_step(_torch_batch(_batch(cfg, "tokens", True)), generator=torch.Generator().manual_seed(1))
    assert modes and not any(modes)
    frozen_params = {id(p) for name in ts2.FROM_STAGE1.values() for p in getattr(port, name).parameters()}
    held = {id(p) for opt in port.optimizers.values() for g in opt.param_groups for p in g["params"]}
    assert held and not (held & frozen_params)
    after = convert.to_numpy(port)
    for k, v in _frozen(before).items():
        assert np.array_equal(after[k], v), k
    for module in ts2.TRAINED:
        assert any(not np.array_equal(after[k], before[k]) for k in before
                   if k.startswith(f"params/{module}/")), module
    for module in ("generator", "critic"):
        assert any(not np.array_equal(after[k], before[k]) for k in before
                   if k.startswith(f"batch_stats/{module}/")), module


@pytest.mark.parametrize("train", [False, True])
def test_stage2_discriminator_matches_jax(train):
    """D2 alone: ``features``, ``score`` and the whole forward (1e-5),
    and in training mode the updated BatchNorm statistics."""
    from imagegenerator_tpu.models.stackgan import StageIIDiscriminator as JD2

    rng = np.random.default_rng(3)
    channels = (6, 8, 12)  # 32 px
    jd = JD2(tem_size=10, nd=5, channels=channels)
    img = rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    tem = rng.standard_normal((3, 10)).astype(np.float32)
    variables = jd.init(jax.random.key(1), jnp.asarray(img), jnp.asarray(tem), train=False)
    flat = flat_variables(variables, rng)
    variables = to_flax_variables(flat)
    td = StageIIDiscriminator(10, 5, channels)
    convert.load_numpy(td, flat)
    td.train(train)
    assert td.head.Conv2d_0.weight.shape[0] == 160
    want_feat, mut = jd.apply(variables, jnp.asarray(img), train=train, method=JD2.features,
                              mutable=["batch_stats"])
    want_score = jd.apply(variables, want_feat, jnp.asarray(tem), method=JD2.score)
    want, _ = jd.apply(variables, jnp.asarray(img), jnp.asarray(tem), train=train, mutable=["batch_stats"])
    with torch.no_grad():
        feat = td.features(torch.from_numpy(img))
        score = td.score(feat, torch.from_numpy(tem))
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(feat.permute(0, 2, 3, 1).numpy(), np.asarray(want_feat), **tol)
    np.testing.assert_allclose(score.numpy(), np.asarray(want_score), **tol)
    if train:
        got_stats = {k: v for k, v in convert.to_numpy(td).items() if k.startswith("batch_stats/")}
        want_stats = flat_variables({"batch_stats": mut["batch_stats"]})
        assert set(got_stats) == set(want_stats)
        for k, v in want_stats.items():
            np.testing.assert_allclose(got_stats[k], v, err_msg=k, **tol)
    convert.load_numpy(td, flat)  # the statistics as before the pass above
    with torch.no_grad():
        out = td(torch.from_numpy(img), torch.from_numpy(tem))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **tol)


def test_optimizer_state_carries_both_ways(jax_steps):
    """JAX state after one step -> port (the three optimizers' moments
    and counts included) -> one port step, against the JAX step from the
    same state; then the port's state -> JAX -> one more step on each
    side."""
    system, state0, step = jax_steps("tokens_f32")
    _, tcfg = _configs({}, False)
    batch = _batch(tcfg, "tokens", False, seed=1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state1, _ = step(state0, jbatch, jax.random.key(21))
    port = convert.stage2_from_numpy(jax_flat(state1, FIELDS), tcfg, "cpu")
    assert port.step == 1
    counts = {m: int(convert.to_numpy(port)[f"opt_state/{m}/count"]) for m in ts2.TRAINED}
    assert counts == {"con_augment_2": 1, "generator": 1, "critic": 2}
    key = jax.random.key(22)
    state2, want = step(state1, jbatch, key)
    got = port.train_step(_torch_batch(batch), noise=jax_noise(system, state1, key))
    _metrics_close(got, want, "jax -> port")
    assert_state_close(port, state2, tcfg, "jax -> port", FIELDS)

    back = jax_state_from_flat(state2, convert.to_numpy(port), FIELDS)
    key = jax.random.key(23)
    state3, want = step(back, jbatch, key)
    got = port.train_step(_torch_batch(batch), noise=jax_noise(system, back, key))
    _metrics_close(got, want, "port -> jax")
    assert_state_close(port, state3, tcfg, "port -> jax", FIELDS)


def test_port_round_trip_continues_exactly():
    """to_numpy -> stage2_from_numpy keeps every tensor and the optimizer
    state: the copy's next step equals the original's bit for bit."""
    cfg = ts2.Stage2Config.tiny(n_critic=2)
    port = ts2.Stage2System(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    batch = _torch_batch(_batch(cfg, "tokens", True, seed=2))
    port.train_step(batch, generator=torch.Generator().manual_seed(1))
    copy = convert.stage2_from_numpy(convert.to_numpy(port), cfg, "cpu")
    assert copy.step == 1
    a = port.train_step(batch, generator=torch.Generator().manual_seed(2))
    b = copy.train_step(batch, generator=torch.Generator().manual_seed(2))
    for k in a:
        assert torch.equal(a[k], b[k]), k
    fa, fb = convert.to_numpy(port), convert.to_numpy(copy)
    assert set(fa) == set(fb)
    for k in fa:
        assert np.array_equal(fa[k], fb[k]), k


@pytest.mark.parametrize("route", ["tokens", "tem"])
def test_noise_order_and_generator_draws(route):
    """Noise drawn from ``generator`` in the documented order (perm, then
    per iteration ca1_eps, z, ca2_eps, gp_eps) equals the same draws
    replayed."""
    cfg = ts2.Stage2Config.tiny(n_critic=2)
    flat = convert.to_numpy(ts2.Stage2System(cfg, device="cpu", generator=torch.Generator().manual_seed(0)))
    batch = _torch_batch(_batch(cfg, route, False, seed=3))
    gen = torch.Generator().manual_seed(5)
    noise = {"perm": torch.randperm(B, generator=gen), "ca1_eps": [], "z": [], "ca2_eps": [], "gp_eps": []}
    for _ in range(cfg.n_critic):
        noise["ca1_eps"].append(torch.randn((B, cfg.c_dim), generator=gen))
        noise["z"].append(torch.randn((B, cfg.z_dim), generator=gen))
        noise["ca2_eps"].append(torch.randn((B, cfg.c_dim), generator=gen))
        noise["gp_eps"].append(torch.rand((B, 1, 1, 1), generator=gen))
    a = convert.stage2_from_numpy(flat, cfg).train_step(batch, generator=torch.Generator().manual_seed(5))
    b = convert.stage2_from_numpy(flat, cfg).train_step(batch, noise=noise)
    for k in a:
        assert torch.isfinite(a[k]) and torch.equal(a[k], b[k]), k


def test_tem_route_equals_tokens_route_on_embedded_texts():
    """``batch['tem'] = embed_texts(tokens)`` takes the step the tokens
    route takes, bit for bit: one eval-mode encoder forward either way."""
    cfg = ts2.Stage2Config.tiny(n_critic=2)
    flat = convert.to_numpy(ts2.Stage2System(cfg, device="cpu", generator=torch.Generator().manual_seed(0)))
    batch = _torch_batch(_batch(cfg, "tokens", True, seed=4))
    a_sys, b_sys = convert.stage2_from_numpy(flat, cfg), convert.stage2_from_numpy(flat, cfg)
    tem = b_sys.embed_texts(batch["input_ids"], batch["attention_mask"])
    assert not tem.requires_grad
    a = a_sys.train_step(batch, generator=torch.Generator().manual_seed(6))
    b = b_sys.train_step({"tem": tem, "image": batch["image"]}, generator=torch.Generator().manual_seed(6))
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_step_matches_the_jax_golden(jax_steps):
    """``tests/goldens/stage2_step.npz`` (``tests/make_goldens.py``:
    ``tiny(n_critic=2)``, init ``key(3)``, batch ``key(4)``, step
    ``key(5)``), with the draws replayed."""
    path = os.path.join(os.path.dirname(__file__), "goldens", "stage2_step.npz")
    want = np.load(path)
    system = jax_steps("tokens_f32")[0]  # the golden's config
    assert system.config == js2.Stage2Config.tiny(n_critic=2)
    state = jax.jit(system.init, static_argnums=1)(jax.random.key(3), 4)
    kt, ki = jax.random.split(jax.random.key(4))
    r = system.config.resolution
    batch = {
        "input_ids": np.asarray(jax.random.randint(kt, (4, system.config.seq_len), 0, 128)),
        "attention_mask": np.ones((4, system.config.seq_len), np.int32),
        "image": np.asarray(jax.random.uniform(ki, (4, r, r, 3), minval=-1, maxval=1)),
    }
    port = convert.stage2_from_numpy(jax_flat(state, FIELDS), ts2.Stage2Config.tiny(n_critic=2), "cpu")
    got = port.train_step(_torch_batch(batch), noise=jax_noise(system, state, jax.random.key(5)))
    assert set(want.files) == set(got)
    for k in want.files:
        np.testing.assert_allclose(float(got[k]), want[k], err_msg=k, **TOL)


def test_load_stage1_copies_the_frozen_stack():
    from imagegenerator_tpu_torch.train.stage1 import Stage1System

    cfg = ts2.Stage2Config.tiny()
    s1 = Stage1System(cfg.stage1_config(), device="cpu", generator=torch.Generator().manual_seed(3))
    for b in s1.generator.buffers():  # statistics that are not the init's
        b.uniform_(0.5, 2.0, generator=torch.Generator().manual_seed(4))
    port = ts2.Stage2System(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    trained = {k: v for k, v in convert.to_numpy(port).items() if not k.startswith(FROZEN)}
    port.load_stage1(s1)
    f1, f2 = convert.to_numpy(s1), convert.to_numpy(port)
    pairs = {"params/encoder/": "frozen_params/encoder/", "params/projection/": "frozen_params/projection/",
             "params/con_augment/": "frozen_params/con_augment_1/", "params/generator/": "frozen_params/gen_1/",
             "batch_stats/generator/": "frozen_gen_stats/"}
    seen = 0
    for k, v in f1.items():
        for src, dst in pairs.items():
            if k.startswith(src):
                assert np.array_equal(f2[dst + k[len(src):]], v), k
                seen += 1
    assert seen == len(_frozen(f2))
    for k, v in trained.items():
        assert np.array_equal(f2[k], v), k
    # a copy, not an alias: stage 1 can train on
    with torch.no_grad():
        s1.projection.weight.add_(1.0)
    assert np.array_equal(convert.to_numpy(port)["frozen_params/projection/kernel"],
                          f2["frozen_params/projection/kernel"])


def test_config_matches_jax():
    keep = lambda d: {k: v for k, v in d.items() if k not in ("bert", "compute_dtype")}
    for j, t in ((js2.Stage2Config(), ts2.Stage2Config()),
                 (js2.Stage2Config.tiny(), ts2.Stage2Config.tiny())):
        assert keep(dataclasses.asdict(j)) == keep(dataclasses.asdict(t))
        assert list(dataclasses.asdict(j)) == list(dataclasses.asdict(t))
        assert dataclasses.asdict(j.bert) == dataclasses.asdict(t.bert)
        assert (j.res1, j.resolution) == (t.res1, t.resolution)
        j1, t1 = j.stage1_config(n_critic=3), t.stage1_config(n_critic=3)
        assert keep(dataclasses.asdict(j1)) == keep(dataclasses.asdict(t1))
    assert tuple(ts2.TRAINED) == js2.TRAINED
