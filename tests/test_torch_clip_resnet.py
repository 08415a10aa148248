"""The port's ModifiedResNet CLIP towers against the JAX package's on the
CPU, at the tiny ResNet shapes of ``tests/test_convert_parity.py``: stage
depths (1, 1, 1, 1) at 64 px and (2, 1, 3, 1) at 96 px. One set of
weights (``seeded_clip_state``: the port's seeded init with He-scaled
convolutions and BatchNorm statistics drawn away from the identity)
crosses to JAX through ``convert.v2_clip_to_flax``; the same numpy-seeded
images go through both. Then the converter's key lists against the JAX
package's ``convert_clip_params`` for every model name of the v2 CLI,
the port's side built on the ``meta`` device.

Tolerances: f32 rtol 1e-5 with atol 1e-5 of the largest output (sums in
another order); bf16 compute 2e-2 of the largest output (the two
frameworks round convolution and product results to bf16 at other
places); the image gradient rtol = atol = 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagegenerator_tpu.v2 import clip as jclip
from imagegenerator_tpu.v2 import convert as jconvert
from imagegenerator_tpu.v2 import generate as jgenerate
from imagegenerator_tpu_torch import convert
from imagegenerator_tpu_torch.v2 import clip as tclip
from imagegenerator_tpu_torch.v2 import generate

TEXT = dict(vocab_size=256, context_length=16, text_width=16, text_layers=2, text_heads=2)
CONFIGS = {
    "1111_64px": dict(embed_dim=32, image_resolution=64, vision_width=16, vision_layers=(1, 1, 1, 1),
                      vision_heads=8, **TEXT),
    "2131_96px": dict(embed_dim=48, image_resolution=96, vision_width=16, vision_layers=(2, 1, 3, 1),
                      vision_heads=8, **TEXT),
}


def seeded_clip_state(cfg, seed: int) -> dict:
    """An OpenAI-named CLIP ``state_dict`` (numpy f32) from the port's
    seeded init, with every convolution scaled to He's variance (torch's
    default init, U(+-1/sqrt(fan_in)), shrinks a deep tower's features
    towards a constant) and each frozen BatchNorm given statistics and an
    affine away from the identity, so that its fold is exercised; the
    last BatchNorm of each bottleneck (``bn3``, which OpenAI's
    initialisation zeroes) is scaled to 0.2-0.3, so that the residual
    stream does not double its variance at each block."""
    model = tclip.CLIP(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in model.state_dict().items():
        a = v.numpy().copy()
        if a.ndim == 4 and cfg.is_resnet:
            a *= np.sqrt(6.0)
        elif k.endswith("running_mean"):
            a = rng.normal(0.0, 0.05, a.shape)
        elif k.endswith("running_var"):
            a = rng.uniform(0.8, 1.2, a.shape)
        elif ".bn" in k or ".downsample.1." in k:
            a = rng.uniform(0.8, 1.2, a.shape) if k.endswith("weight") else rng.normal(0.0, 0.1, a.shape)
            if ".layer" in k and ".bn3.weight" in k:
                a *= 0.25
        sd[k] = a.astype(np.float32)
    return sd


def _load(cfg, sd, dtype=None):
    model = tclip.CLIP(cfg, dtype, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return model.eval().requires_grad_(False)


@pytest.fixture(scope="module", params=list(CONFIGS))
def rn(request):
    cfg = tclip.CLIPConfig(**CONFIGS[request.param])
    sd = seeded_clip_state(cfg, seed=len(request.param))
    return cfg, jclip.CLIPConfig(**CONFIGS[request.param]), sd, convert.v2_clip_to_flax(sd, cfg)


def _jax_apply(jcfg, params, dtype, method, x):
    fn = jax.jit(lambda p, a: jclip.CLIP(jcfg, dtype=dtype).apply({"params": p}, a, method=method))
    return np.asarray(fn(params, jnp.asarray(x)), np.float32)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_resnet_towers_match_jax(rn, dtype):
    cfg, jcfg, sd, params = rn
    jdtype = None if dtype is None else jnp.bfloat16
    model = _load(cfg, sd, dtype)
    rng = np.random.default_rng(4)
    images = rng.normal(size=(3, cfg.image_resolution, cfg.image_resolution, 3)).astype(np.float32)
    tokens = np.zeros((3, 16), np.int32)
    for row, n in enumerate((5, 16, 9)):  # SOT ... EOT, the EOT id the largest
        tokens[row, :n] = [254, *rng.integers(1, 254, n - 2), 255]
    for method, x in ((jclip.CLIP.encode_image, images), (jclip.CLIP.encode_text, tokens)):
        got = getattr(model, method.__name__)(torch.from_numpy(x))
        assert got.dtype == (dtype or torch.float32)
        got = got.float().numpy()
        want = _jax_apply(jcfg, params, jdtype, method, x)
        assert got.shape == want.shape == (3, cfg.embed_dim)
        scale = np.abs(want).max()
        if dtype is None:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale, err_msg=method.__name__)
        else:
            assert np.abs(got - want).max() <= 2e-2 * scale, method.__name__


def test_resnet_image_gradient_matches_jax(rn):
    cfg, jcfg, sd, params = rn
    model = _load(cfg, sd)
    rng = np.random.default_rng(5)
    images = rng.normal(size=(2, cfg.image_resolution, cfg.image_resolution, 3)).astype(np.float32)
    cot = rng.normal(size=(2, cfg.embed_dim)).astype(np.float32)
    leaf = torch.from_numpy(images).requires_grad_(True)
    model.encode_image(leaf).backward(torch.from_numpy(cot))
    encode = lambda p, a: jclip.CLIP(jcfg).apply({"params": p}, a, method=jclip.CLIP.encode_image)  # noqa: E731
    image_grad = jax.jit(lambda p, a, c: jax.vjp(lambda x: encode(p, x), a)[1](c)[0])
    want = np.asarray(image_grad(params, jnp.asarray(images), jnp.asarray(cot)))
    np.testing.assert_allclose(leaf.grad.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_resnet_config_inference_matches_jax(rn):
    cfg, _, sd, _ = rn
    got = tclip.clip_config_from_state_dict(sd)
    want = jconvert.clip_config_from_state_dict(sd)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    # OpenAI's rules: text heads = width // 64, vision heads = 32 w / 64
    assert got == dataclasses.replace(cfg, text_heads=1)


def test_resnet_state_dict_has_openais_names_and_round_trips(rn):
    cfg, jcfg, sd, params = rn
    assert set(tclip.CLIP(cfg, device="meta").state_dict()) == set(sd)
    for key in ("visual.conv1.weight", "visual.bn3.running_var", "visual.layer1.0.downsample.0.weight",
                "visual.layer2.0.downsample.1.running_mean", "visual.layer4.0.conv2.weight",
                "visual.attnpool.positional_embedding", "visual.attnpool.c_proj.bias"):
        assert key in sd, key
    w = cfg.vision_width
    assert sd["visual.conv1.weight"].shape == (w // 2, 3, 3, 3)
    assert sd["visual.attnpool.positional_embedding"].shape == ((cfg.image_resolution // 32) ** 2 + 1, 32 * w)
    assert sd["visual.attnpool.c_proj.weight"].shape == (cfg.embed_dim, 32 * w)
    # no shortcut where neither the stride nor the width changes
    if cfg.vision_layers[0] > 1:
        assert "visual.layer1.1.downsample.0.weight" not in sd
    back = jconvert.convert_clip_params(sd, jcfg)
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = jax.tree_util.tree_leaves_with_path(back)
    assert len(got) == len(want)
    for path, leaf in got:
        np.testing.assert_array_equal(leaf, want[path])
    again = convert.v2_clip_from_flax(params, cfg)
    assert set(again) == set(sd)
    for k, v in again.items():
        np.testing.assert_array_equal(v, sd[k], err_msg=k)


def test_a_published_layout_loads_strictly_through_load_clip(rn, tmp_path):
    """A ``.pt`` as OpenAI ships it (``logit_scale``, the shape scalars,
    BatchNorm's ``num_batches_tracked``): ``load_clip`` drops what is no
    parameter, and the rest loads with ``strict=True``."""
    cfg, _, sd, _ = rn
    published = {k: torch.from_numpy(v) for k, v in sd.items()}
    published.update({k.replace("running_var", "num_batches_tracked"): torch.tensor(3)
                      for k in sd if k.endswith("running_var")})
    published.update(logit_scale=torch.tensor(4.6), input_resolution=torch.tensor(cfg.image_resolution),
                     context_length=torch.tensor(16), vocab_size=torch.tensor(256))
    torch.save(published, tmp_path / "rn.pt")
    got_cfg, got_sd = generate.load_clip("RN50", str(tmp_path / "rn.pt"))
    assert got_cfg == dataclasses.replace(cfg, text_heads=1) and set(got_sd) == set(sd)
    _load(got_cfg, {k: v.numpy() for k, v in got_sd.items()})
    with pytest.raises(RuntimeError, match="num_batches_tracked"):
        tclip.CLIP(got_cfg, device="meta").load_state_dict(published, strict=True, assign=True)


def _zeros(shape):
    """Zeros of ``shape`` in one element of memory, however wide."""
    return np.lib.stride_tricks.as_strided(np.zeros(1, np.float32), shape, (0,) * len(shape))


class _Recorder(dict):
    """A ``state_dict`` stand-in that notes each key read."""

    def __init__(self, arrays):
        super().__init__(arrays)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


@pytest.mark.parametrize("name", list(generate.CLIP_CONFIGS))
def test_key_lists_match_the_jax_converter(name):
    """For every model name of the v2 CLI: the port's ``state_dict`` names
    (built on ``meta``) are the OpenAI names the JAX converter reads, the
    port's config inference gives the preset back, and the port's own
    converter pairs each name with a flax path of the JAX tree."""
    cfg = generate.CLIP_CONFIGS[name]()
    jcfg = jgenerate.CLIP_CONFIGS[name]()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    sd = {k: _zeros(tuple(v.shape)) for k, v in tclip.CLIP(cfg, device="meta").state_dict().items()}
    recorder = _Recorder(sd)
    tree = jconvert.convert_clip_params(recorder, jcfg)
    assert recorder.read == set(sd), (sorted(recorder.read - set(sd))[:5], sorted(set(sd) - recorder.read)[:5])
    assert tclip.clip_config_from_state_dict(sd) == cfg
    paths = {tuple(p.key for p in path) for path, _ in jax.tree_util.tree_leaves_with_path(tree)}
    entries = convert._clip_entries(cfg)
    assert {key for key, _, _ in entries} == set(sd)
    assert {path for _, path, _ in entries} == paths
