"""Parity of the PyTorch port's v1 models with the JAX package's, in f32
on the CPU: conditioning augmentation, the Stage-I and Stage-II
generators at tiny widths (eval mode, BatchNorm statistics redrawn), and
G1 against the golden ``tests/goldens/models.npz``.

Tolerance: rtol = atol = 1e-5."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from torch.utils._python_dispatch import TorchDispatchMode

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



# ---------------------------------------------------------- memory format

CL = torch.channels_last


def _channels_last(t):
    """``t`` has exactly the strides of a channels-last tensor of its
    shape, so that cuDNN's own rule (``suggest_memory_format``) reads it
    as NHWC, including a 1x1 map or a 1x1 kernel, whose NCHW strides would
    pass ``is_contiguous(memory_format=channels_last)`` too."""
    return t.dim() == 4 and t.stride() == torch.empty(t.shape, device="meta", memory_format=CL).stride()


class _MixedLayouts(TorchDispatchMode):
    """Records each operator, forward, backward or the penalty's double
    backward, that takes activations of one shape in both layouts,
    channels-last and NCHW: an operator that reads one of them a strided
    element at a time. Activations are the 4-D tensors whose first axis
    is the batch, with a map and channels both wider than 1 (the two
    layouts coincide otherwise). On the CPU the backward runs on the
    calling thread, so the mode sees it."""

    def __init__(self, batch):
        super().__init__()
        self.batch, self.ops = batch, set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        seen = {}
        for t in args:
            if (isinstance(t, torch.Tensor) and t.dim() == 4 and t.shape[0] == self.batch
                    and t.shape[1] > 1 and t.shape[2] * t.shape[3] > 1):
                seen.setdefault(tuple(t.shape), set()).add(
                    "cl" if _channels_last(t) else "nchw" if t.is_contiguous() else "other")
        if any({"cl", "nchw"} <= kinds for kinds in seen.values()):
            self.ops.add(str(func))
        return func(*args, **(kwargs or {}))


def _tiny_system(stage, device="cpu"):
    from imagegenerator_tpu_torch.train.stage1 import Stage1Config, Stage1System
    from imagegenerator_tpu_torch.train.stage2 import Stage2Config, Stage2System

    cls, cfg = ((Stage1System, Stage1Config.tiny(n_critic=2)) if stage == 1
                else (Stage2System, Stage2Config.tiny(n_critic=2)))
    return cls(cfg, device=device, generator=torch.Generator().manual_seed(stage))


def _tiny_batch(system, n=4):
    c, g = system.config, torch.Generator().manual_seed(7)
    res = getattr(c, "resolution", None) or 2 ** (len(c.gen_channels) + 2)
    batch = {"image": torch.randint(0, 256, (n, res, res, 3), generator=g, dtype=torch.uint8)}
    if hasattr(system, "critic_2"):
        batch["tem"] = torch.randn((n, c.tem_size), generator=g)
    else:
        batch["input_ids"] = torch.randint(1, c.bert.vocab_size, (n, c.seq_len), generator=g)
        batch["attention_mask"] = torch.ones((n, c.seq_len), dtype=torch.long)
    return batch


def _assert_step_runs_channels_last(system, monkeypatch):
    """One train step and one ``sample`` with every conv call recorded:
    input, weight and output channels-last in every call, the gradient
    penalty's interpolation pass and the critic head's 1x1 conv among
    them; every parameter keeps its strides and its gradient takes them;
    ``sample`` returns plain NHWC memory. The wrapper sees the forward
    calls; ``_MixedLayouts`` sees every operator, the backward's and the
    double backward's too. cuDNN's own transforms show only in a trace
    on the card."""
    from imagegenerator_tpu_torch.ops import conv as conv_ops
    from imagegenerator_tpu_torch.train import schedules

    calls = []

    def recorded(fn):
        def call(x, w, b=None, **kw):
            y = fn(x, w, b, **kw)
            calls.append((_channels_last(x), _channels_last(w), _channels_last(y)))
            return y
        return call

    monkeypatch.setattr(conv_ops, "conv2d", recorded(conv_ops.conv2d))
    monkeypatch.setattr(conv_ops, "conv_transpose2d", recorded(conv_ops.conv_transpose2d))
    critic = getattr(system, "critic_2", None) or system.critic
    passes = {"stem": 0, "head": 0}
    for name, m in (("stem", critic.conv_in), ("head", critic.head.Conv2d_0)):
        m.register_forward_pre_hook(lambda *_, name=name: passes.__setitem__(name, passes[name] + 1))
    strides = {n: p.stride() for n, p in system.named_parameters()}
    batch = _tiny_batch(system)
    kw = {} if hasattr(system, "critic_2") else {"host_generator": torch.Generator().manual_seed(2)}
    with _MixedLayouts(len(batch["image"])) as mixed:
        system.train_step(batch, generator=torch.Generator().manual_seed(1), **kw)
    bad = [i for i, c in enumerate(calls) if not all(c)]
    assert calls and not bad, bad
    assert not mixed.ops, mixed.ops
    # per critic iteration: real, fake and the penalty's interpolation through
    # the tower, four scores; then the generator step's one pass
    n = system.config.n_critic
    assert passes == {"stem": 3 * n + 1, "head": 4 * n + 1}
    for name, p in system.named_parameters():
        assert p.stride() == strides[name], name
        if p.grad is not None:
            assert schedules.strided_alike(p.grad, p), name
    images = system.sample({"tem": batch.get("tem", torch.randn(4, system.config.tem_size))},
                           generator=torch.Generator().manual_seed(3))
    assert images.shape[-1] == 3 and images.is_contiguous()


@pytest.mark.parametrize("stage", [1, 2])
def test_every_conv_of_the_training_step_is_channels_last(stage, monkeypatch):
    _assert_step_runs_channels_last(_tiny_system(stage), monkeypatch)


@pytest.mark.parametrize("stage", [1, 2])
def test_channels_last_does_not_hinge_on_how_parameters_were_made(stage, monkeypatch, tmp_path):
    """A system loaded by ``convert.load_numpy`` (its tensors replaced by
    ``assign=True``, the conv weights in the npz's HWIO memory) runs the
    same layouts, and its tensors read back as the npz's arrays under
    ``convert.to_flax``."""
    path = tmp_path / "state.npz"
    np.savez(path, **convert.to_numpy(_tiny_system(stage)))
    flat = dict(np.load(path))
    system = _tiny_system(stage, device="meta")
    convert.load_numpy(system, flat, "cpu")
    sd = system.state_dict()
    for key, flat_key, layout in convert.entries(system):
        np.testing.assert_array_equal(convert.to_flax(sd[key], layout), flat[flat_key], err_msg=key)
    _assert_step_runs_channels_last(system, monkeypatch)
