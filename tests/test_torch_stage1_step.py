"""The port's stage-1 training step (``Stage1System.train_step``) against
the JAX package's ``make_train_step``, in f32 on the CPU, at
``Stage1Config.tiny(n_critic=2, text_dropout=False)``: the same flax
initial state converted by ``imagegenerator_tpu_torch.convert``, the same
batch, and the JAX key tree's noise (permutation, CA eps, z, GP eps)
replayed into the port. With ``fused_attention`` (and ``fused_ln``) on,
the JAX side runs its Pallas kernels in interpret mode and the port its
kernels' plain versions.

Each step starts both sides from the same state (the second step from
the port's state after the first, converted back to JAX), so each check
reads one step's arithmetic and not a drift that compounds.

Tolerances: metrics and BatchNorm statistics rtol = atol = 1e-4 (a
second-order critic loss over a BERT stack). Gradients, read from the
optimizers' first moments (optax ``mu``, torch ``exp_avg``): within
``GRAD_TOL`` of the tensor's largest moment G plus 1e-4 relative (the
two sides sum in different orders; 5e-6 G to 5e-5 G is read). Parameters:
within ``PARAM_TOL`` times the module's learning rate, plus 1e-5
relative, plus what Adam makes of a gradient difference within
``GRAD_TOL * G`` at that element: its update ``m / (sqrt(v) + 1e-8)``
moves by up to ``2 * GRAD_TOL * G / (sqrt(v) + 1e-8)`` lr per update,
capped at 2 lr per update. That term is negligible where the element's
gradient is of the tensor's scale and reaches the cap where it is near
zero: at Adam's first update a gradient that is rounding noise around
zero moves its element by +-lr in a direction that rounding decides.
``_noise_grad`` names the elements whose gradient is zero by structure,
which take the cap outright (their moments are noise too):

* the attention key bias: softmax is shift-invariant along the keys;
* the critic head's text path (``Dense_0``, the 1x1 conv's text input
  channels) and the biases after it (``Conv2d_0``, ``Dense_1``): the
  head is linear, so its text term and any constant add the same amount
  to ``mean(real)`` and to ``mean([mismatched, fake])``, whose tem rows
  are a permutation of the real ones; the critic loss cancels them, and
  the GP's image gradient does not see them."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from imagegenerator_tpu.models.bert import BertConfig as JBertConfig
from imagegenerator_tpu.train import stage1 as js1
from imagegenerator_tpu_torch import convert
from imagegenerator_tpu_torch.models.bert import BertConfig
from imagegenerator_tpu_torch.train import stage1 as ts1
from tests.test_torch_sample import _eps

torch.set_num_threads(2)
B = 4
TOL = dict(rtol=1e-4, atol=1e-4)
PARAM_TOL = 1e-3
GRAD_TOL = 1e-4
CASES = {
    # kl_mode, text policy, attention and LayerNorm route, image dtype
    "hoisted_reuse": dict(kw=dict(), fused=False, uint8=False),
    "per_iter_faithful_fused": dict(kw=dict(text_resample_per_iter=True, kl_mode="faithful"),
                                    fused=True, uint8=True),
    "hoisted_doubled_fused": dict(kw=dict(text_reuse_mismatched=False), fused=True, uint8=False),
}


def _configs(kw, fused):
    extra = dict(fused_attention=fused, fused_ln=fused)
    jcfg = js1.Stage1Config.tiny(n_critic=2, text_dropout=False,
                                 bert=dataclasses.replace(JBertConfig.tiny(), **extra), **kw)
    tcfg = ts1.Stage1Config.tiny(n_critic=2, text_dropout=False,
                                 bert=dataclasses.replace(BertConfig.tiny(), **extra), **kw)
    return jcfg, tcfg


def _batch(cfg, uint8, seed=0):
    rng = np.random.default_rng(seed)
    T, r = cfg.seq_len, cfg.resolution
    mask = np.ones((B, T), np.int32)
    mask[1, T // 2:] = 0
    mask[3, 3:] = 0
    if uint8:
        image = rng.integers(0, 256, (B, r, r, 3)).astype(np.uint8)
    else:
        image = rng.uniform(-1, 1, (B, r, r, 3)).astype(np.float32)
    return {"input_ids": rng.integers(0, cfg.bert.vocab_size, (B, T)).astype(np.int32),
            "attention_mask": mask, "image": image}


def _noise(system, state, key):
    """The draws of the JAX step's key tree (``stage1.py:367-377, 456,
    518``): perm, then per critic iteration CA eps, z and GP eps."""
    c = system.config
    k_perm, k_loop = jax.random.split(key)
    noise = {"perm": jax.random.permutation(k_perm, B), "ca_eps": [], "z": [], "gp_eps": []}
    tem = jnp.zeros((B, c.tem_size))
    for it_key in jax.random.split(k_loop, c.n_critic):
        _, k_ca, k_z, k_gp = jax.random.split(it_key, 4)
        noise["ca_eps"].append(_eps(system.con_augment, state.params["con_augment"], tem, k_ca))
        noise["z"].append(jax.random.normal(k_z, (B, c.z_dim), jnp.float32))
        noise["gp_eps"].append(jax.random.uniform(k_gp, (B, 1, 1, 1), dtype=jnp.float32))
    return {k: torch.from_numpy(np.array(v)) for k, v in noise.items()}


def _adam(opt_state):
    return next(s for s in opt_state if hasattr(s, "mu"))


def jax_flat(state) -> dict:
    """A ``Stage1State`` as the flat dict of ``convert``, optimizer state
    and step included."""
    flat = {}
    for field in ("params", "batch_stats"):
        for path, a in traverse_util.flatten_dict(getattr(state, field)).items():
            flat[field + "/" + "/".join(path)] = np.asarray(a)
    for m, st in state.opt_state.items():
        adam = _adam(st)
        flat[f"opt_state/{m}/count"] = np.asarray(adam.count)
        for name in ("mu", "nu"):
            for path, a in traverse_util.flatten_dict(getattr(adam, name)).items():
                flat[f"opt_state/{m}/{name}/" + "/".join(path)] = np.asarray(a)
    flat["step"] = np.asarray(state.step)
    return flat


def jax_state_from_flat(template, flat):
    """The inverse of ``jax_flat`` on the structure of ``template``."""

    def tree(prefix):
        items = {tuple(k[len(prefix):].split("/")): jnp.asarray(v)
                 for k, v in flat.items() if k.startswith(prefix)}
        return traverse_util.unflatten_dict(items)

    opt_state = {}
    for m, st in template.opt_state.items():
        count = jnp.asarray(flat[f"opt_state/{m}/count"], jnp.int32)
        parts = []
        for s in st:
            if hasattr(s, "mu"):
                s = s._replace(count=count, mu=tree(f"opt_state/{m}/mu/"), nu=tree(f"opt_state/{m}/nu/"))
            elif "count" in s._fields:
                s = s._replace(count=count)
            parts.append(s)
        opt_state[m] = type(st)(parts)
    return template.replace(params=tree("params/"), batch_stats=tree("batch_stats/"),
                            opt_state=opt_state, step=jnp.asarray(flat["step"], jnp.int32))


def _lr(cfg, flat_key):
    module = flat_key.split("/")[1]
    return cfg.encoder_lr if module == "encoder" else cfg.lr


def _noise_grad(key, shape, cfg):
    """Mask of the elements whose gradient is zero by structure (see the
    module docstring)."""
    mask = np.zeros(shape, bool)
    if key.endswith("/attention/key/bias") or "/head/Dense_0/" in key or key in (
        "params/critic/head/Conv2d_0/bias", "params/critic/head/Dense_1/bias",
    ):
        mask[...] = True
    elif key == "params/critic/head/Conv2d_0/kernel":  # HWIO: text channels last
        mask[:, :, cfg.disc_channels[-1]:, :] = True
    return mask


def assert_state_close(port, jstate, cfg, what):
    got = convert.to_numpy(port)
    want = jax_flat(jstate)
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape, (what, key)
        if key.startswith("batch_stats/") or key == "step" or key.endswith("/count"):
            np.testing.assert_allclose(g, w, err_msg=f"{what} {key}", **TOL)
        if not key.startswith("params/"):
            continue
        module, path = key.split("/", 2)[1:]
        count = int(want[f"opt_state/{module}/count"])
        mu_key = f"opt_state/{module}/mu/{path}"
        mu_w, mu_g = want[mu_key], got[mu_key]
        named = _noise_grad(key, w.shape, cfg)
        scale = np.abs(np.where(named, 0.0, mu_w)).max()
        mu_err = np.abs(mu_g - mu_w)
        assert (named | (mu_err <= GRAD_TOL * scale + 1e-4 * np.abs(mu_w))).all(), (
            what, mu_key, float(mu_err[~named].max() / scale), "x the largest moment")
        # Adam's sensitivity at this element, in units of lr, per update
        grad_scale = scale / (1 - 0.9 ** count)
        rms = np.sqrt(want[f"opt_state/{module}/nu/{path}"] / (1 - 0.999 ** count))
        moves = np.where(named, 2.0, np.minimum(2.0, 2 * GRAD_TOL * grad_scale / (rms + 1e-8)))
        lr = _lr(cfg, key)
        bound = lr * (PARAM_TOL + count * moves) + 1e-5 * np.abs(w)
        err = np.abs(g - w)
        assert (err <= bound).all(), (what, key, float(((err - bound) / lr).max()), "x lr over")


def _metrics_close(got, want, what):
    for name in ("loss_critic", "loss_gen", "gp", "kl"):
        np.testing.assert_allclose(float(got[name]), float(want[name]), err_msg=f"{what} {name}", **TOL)


@pytest.fixture(scope="module")
def jax_steps():
    """One compiled JAX step per case (compiles are most of the time)."""
    cache = {}

    def get(name):
        if name not in cache:
            jcfg, _ = _configs(CASES[name]["kw"], CASES[name]["fused"])
            system = js1.Stage1System(jcfg)
            state = jax.jit(system.init, static_argnums=1)(jax.random.key(0), B)
            cache[name] = system, state, js1.make_train_step(system, donate=False)
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(CASES))
def test_two_steps_match_jax(name, jax_steps):
    case = CASES[name]
    system, state, step = jax_steps(name)
    _, tcfg = _configs(case["kw"], case["fused"])
    port = convert.stage1_from_numpy(jax_flat(state), tcfg, "cpu")
    batch = _batch(tcfg, case["uint8"])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for i, seed in enumerate((11, 12)):
        if i:  # both sides take the second step from the port's state
            state = jax_state_from_flat(state, convert.to_numpy(port))
        key = jax.random.key(seed)
        noise = _noise(system, state, key)
        state, want = step(state, jbatch, key)
        got = port.train_step(tbatch, noise=noise)
        _metrics_close(got, want, f"{name} step {i + 1}")
        assert_state_close(port, state, tcfg, f"{name} step {i + 1}")
    assert port.step == 2


def test_optimizer_state_carries_both_ways(jax_steps):
    """JAX state after one step -> port (optimizer moments and counts
    included) -> one port step, against the JAX step from the same state;
    then the port's state -> JAX -> one more step on each side."""
    system, state0, step = jax_steps("hoisted_reuse")
    _, tcfg = _configs({}, False)
    batch = _batch(tcfg, False, seed=1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    state1, _ = step(state0, jbatch, jax.random.key(21))
    port = convert.stage1_from_numpy(jax_flat(state1), tcfg, "cpu")
    assert port.step == 1
    key = jax.random.key(22)
    state2, want = step(state1, jbatch, key)
    got = port.train_step(tbatch, noise=_noise(system, state1, key))
    _metrics_close(got, want, "jax -> port")
    assert_state_close(port, state2, tcfg, "jax -> port")

    back = jax_state_from_flat(state2, convert.to_numpy(port))
    key = jax.random.key(23)
    state3, want = step(back, jbatch, key)
    got = port.train_step(tbatch, noise=_noise(system, back, key))
    _metrics_close(got, want, "port -> jax")
    assert_state_close(port, state3, tcfg, "port -> jax")


def test_port_round_trip_continues_exactly():
    """to_numpy -> stage1_from_numpy keeps every tensor and the optimizer
    state: the copy's next step equals the original's bit for bit."""
    cfg = ts1.Stage1Config.tiny(n_critic=2, text_dropout=False)
    port = ts1.Stage1System(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, True, seed=2).items()}
    port.train_step(batch, generator=torch.Generator().manual_seed(1))
    copy = convert.stage1_from_numpy(convert.to_numpy(port), cfg, "cpu")
    a = port.train_step(batch, generator=torch.Generator().manual_seed(2))
    b = copy.train_step(batch, generator=torch.Generator().manual_seed(2))
    for k in a:
        assert torch.equal(a[k], b[k]), k
    fa, fb = convert.to_numpy(port), convert.to_numpy(copy)
    assert set(fa) == set(fb)
    for k in fa:
        assert np.array_equal(fa[k], fb[k]), k


def test_noise_order_and_generator_draws():
    """Noise drawn from ``generator`` in the documented order (perm, then
    per iteration ca_eps, z, gp_eps) equals the same draws replayed."""
    cfg = ts1.Stage1Config.tiny(n_critic=2, text_dropout=False)
    flat = convert.to_numpy(ts1.Stage1System(cfg, device="cpu", generator=torch.Generator().manual_seed(0)))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, False, seed=3).items()}
    gen = torch.Generator().manual_seed(5)
    noise = {"perm": torch.randperm(B, generator=gen), "ca_eps": [], "z": [], "gp_eps": []}
    for _ in range(cfg.n_critic):
        noise["ca_eps"].append(torch.randn((B, cfg.c_dim), generator=gen))
        noise["z"].append(torch.randn((B, cfg.z_dim), generator=gen))
        noise["gp_eps"].append(torch.rand((B, 1, 1, 1), generator=gen))
    a = convert.stage1_from_numpy(flat, cfg).train_step(batch, generator=torch.Generator().manual_seed(5))
    b = convert.stage1_from_numpy(flat, cfg).train_step(batch, noise=noise)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("fused", [False, True])
def test_step_with_text_dropout_runs_and_updates_every_module(fused):
    """Dropout on at every BERT site (the fused path's attention dropout
    in the kernel's plain version, seeds from a CPU generator): finite
    metrics, every module updated, and the draws decided by the
    generators (same generators, same step)."""
    bert = dataclasses.replace(BertConfig.tiny(), fused_attention=fused, fused_ln=fused,
                               dropout_bits=16, gelu_output_bwd=True)
    cfg = ts1.Stage1Config.tiny(n_critic=2, bert=bert)
    flat = convert.to_numpy(ts1.Stage1System(cfg, device="cpu", generator=torch.Generator().manual_seed(0)))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, True, seed=4).items()}
    runs = []
    for _ in range(2):
        port = convert.stage1_from_numpy(flat, cfg)
        m = port.train_step(batch, generator=torch.Generator().manual_seed(6),
                            host_generator=torch.Generator().manual_seed(7))
        runs.append((m, convert.to_numpy(port)))
    (m, after), (m2, _) = runs
    for k in m:
        assert torch.isfinite(m[k]) and torch.equal(m[k], m2[k]), k
    for module in ts1.MODULES:
        assert any(not np.array_equal(after[k], flat[k]) for k in flat
                   if k.startswith(f"params/{module}/")), module


def test_remat_is_not_ported():
    cfg = ts1.Stage1Config.tiny(remat=True)
    port = ts1.Stage1System(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="remat"):
        port.train_step({k: torch.from_numpy(v) for k, v in _batch(cfg, False).items()})


def test_config_matches_jax():
    keep = lambda d: {k: v for k, v in d.items() if k not in ("bert", "compute_dtype")}
    for j, t in ((js1.Stage1Config(), ts1.Stage1Config()),
                 (js1.Stage1Config.tiny(), ts1.Stage1Config.tiny())):
        assert keep(dataclasses.asdict(j)) == keep(dataclasses.asdict(t))
        assert dataclasses.asdict(j.bert) == dataclasses.asdict(t.bert)
    assert ts1.MODULES == js1.MODULES and ts1.GEN_SIDE == js1.GEN_SIDE
