"""The port's v2 models and gradient utilities against the JAX package on
the CPU at the tiny configurations: the same parameters (drawn by flax
from a key, carried over by ``convert.v2_*_from_flax``) and the same
inputs (from a numpy seed) through both.

Tolerances: f32 rtol = atol = 1e-4 (sums in another order; GroupNorm's
variance by another formula). bf16 compute: the two frameworks round to
bf16 at other places (conv and matmul results, activations), so outputs
are held to 5e-2 of their largest magnitude.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagegenerator_tpu.ops import grad_utils as jgu
from imagegenerator_tpu.v2 import clip as jclip
from imagegenerator_tpu.v2 import convert as jconvert
from imagegenerator_tpu.v2 import vqgan as jvqgan
from imagegenerator_tpu_torch import convert
from imagegenerator_tpu_torch.ops import grad_utils as tgu
from imagegenerator_tpu_torch.v2 import clip as tclip
from imagegenerator_tpu_torch.v2 import vqgan as tvqgan


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def vqgan_pair():
    cfg = jvqgan.VQGANConfig.tiny()
    params = _np_tree(jvqgan.VQModel(cfg).init(
        jax.random.key(0), jnp.zeros((1, cfg.resolution, cfg.resolution, 3)))["params"])
    # the taming init keeps codes within +-1/32; spread them so that the
    # encoder's outputs have distinct nearest codes
    params["codebook"] = np.random.default_rng(0).normal(size=params["codebook"].shape).astype(np.float32)
    return cfg, params, convert.v2_vqgan_from_flax(params, tvqgan.VQGANConfig.tiny())


@pytest.fixture(scope="module")
def clip_pair():
    cfg = jclip.CLIPConfig.tiny()
    params = _np_tree(jclip.CLIP(cfg).init(
        jax.random.key(1), jnp.zeros((1, cfg.image_resolution, cfg.image_resolution, 3)),
        jnp.zeros((1, cfg.context_length), jnp.int32))["params"])
    return cfg, params, convert.v2_clip_from_flax(params, tclip.CLIPConfig.tiny())


def _load(module, sd):
    module.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in sd.items()}, strict=True)
    return module.eval()


def _close(got, want, dtype):
    got, want = got.detach().float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype is None:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()


# ------------------------------------------------------------ grad utils
@pytest.mark.parametrize("shape_b", [(3, 4), (1, 4), (4,), (3, 1)])
def test_replace_grad_matches_jax(shape_b):
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(2, 3, 4)).astype(np.float32), rng.normal(size=shape_b).astype(np.float32)
    cot = rng.normal(size=(2, 3, 4)).astype(np.float32)
    ta, tb = torch.from_numpy(a).requires_grad_(True), torch.from_numpy(b).requires_grad_(True)
    out = tgu.replace_grad(ta, tb)
    out.backward(torch.from_numpy(cot))
    want, vjp = jax.vjp(jgu.replace_grad, jnp.asarray(a), jnp.asarray(b))
    ga, gb = vjp(jnp.asarray(cot))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    assert ta.grad is None and not np.asarray(ga).any()
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb), rtol=1e-6, atol=1e-6)


def test_clamp_with_grad_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.uniform(-0.5, 1.5, (5, 7)).astype(np.float32)
    x[0, :3] = [0.0, 1.0, 0.5]
    cot = rng.normal(size=(5, 7)).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tgu.clamp_with_grad(tx, 0.0, 1.0)
    out.backward(torch.from_numpy(cot))
    want, vjp = jax.vjp(lambda a: jgu.clamp_with_grad(a, 0.0, 1.0), jnp.asarray(x))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]))


def test_clip_has_jnp_clips_gradient_at_a_bound():
    """Half the gradient where x sits exactly on a bound (JAX splits the
    tie of maximum/minimum), where ``torch.clamp`` passes all of it."""
    x = np.array([-0.5, 0.0, 0.25, 1.0, 1.5, 0.0, 1.0], np.float32)
    cot = np.arange(1, 8, dtype=np.float32)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tgu.clip(tx, 0.0, 1.0)
    out.backward(torch.from_numpy(cot))
    want, vjp = jax.vjp(lambda a: jnp.clip(a, 0.0, 1.0), jnp.asarray(x))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]))
    np.testing.assert_array_equal(tx.grad.numpy(), cot * [0, 0.5, 1, 0.5, 0, 0.5, 0.5])
    plain = torch.from_numpy(x).requires_grad_(True)
    plain.clamp(0.0, 1.0).backward(torch.from_numpy(cot))
    assert not np.array_equal(plain.grad.numpy(), tx.grad.numpy())


# ----------------------------------------------------------------- VQGAN
@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_vqgan_encode_decode_match_flax(vqgan_pair, dtype):
    cfg, params, sd = vqgan_pair
    jdtype = None if dtype is None else jnp.bfloat16
    jmodel = jvqgan.VQModel(cfg, dtype=jdtype)
    port = _load(tvqgan.VQModel(tvqgan.VQGANConfig.tiny(), dtype, device="cpu"), sd)
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    # the encoder up to the codebook, then encode itself
    jh = jmodel.apply({"params": params}, jnp.asarray(x),
                      method=lambda m, a: m.quant_conv(m.encoder(a)))
    th = port.quant_conv(port.encoder(torch.from_numpy(x).permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
    _close(th, jh, dtype)
    jz, jidx = jmodel.apply({"params": params}, jnp.asarray(x), method=jvqgan.VQModel.encode)
    tz, tidx = port.encode(torch.from_numpy(x))
    assert tidx.shape == (2, 16, 16) and tz.shape == (2, 16, 16, 8)
    if dtype is None:
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(tz.detach().numpy(), np.asarray(jz))
    z = rng.normal(size=(2, 4, 4, 8)).astype(np.float32)
    _close(port.decode(torch.from_numpy(z)), jmodel.apply({"params": params}, jnp.asarray(z),
                                                            method=jvqgan.VQModel.decode), dtype)
    tq = port.quantize(torch.from_numpy(z))
    jq = jmodel.apply({"params": params}, jnp.asarray(z), method=jvqgan.VQModel.quantize)
    np.testing.assert_array_equal(tq.detach().numpy(), np.asarray(jq))


def test_vqgan_decoder_input_gradient_matches_flax(vqgan_pair):
    cfg, params, sd = vqgan_pair
    port = _load(tvqgan.VQModel(tvqgan.VQGANConfig.tiny(), device="cpu"), sd).requires_grad_(False)
    rng = np.random.default_rng(3)
    z = rng.normal(size=(1, 4, 4, 8)).astype(np.float32)
    cot = rng.normal(size=(1, 8, 8, 3)).astype(np.float32)
    tz = torch.from_numpy(z).requires_grad_(True)
    port.decode(tz).backward(torch.from_numpy(cot))
    _, vjp = jax.vjp(lambda a: jvqgan.VQModel(cfg).apply({"params": params}, a, method=jvqgan.VQModel.decode),
                     jnp.asarray(z))
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]), rtol=1e-4, atol=1e-4)


def test_vqgan_state_dict_has_tamings_names_and_round_trips(vqgan_pair):
    cfg, params, sd = vqgan_pair
    port = tvqgan.VQModel(tvqgan.VQGANConfig.tiny(), device="cpu")
    assert set(port.state_dict()) == set(sd)
    for key in ("encoder.conv_in.weight", "encoder.down.0.block.0.norm1.weight",
                "encoder.down.1.block.0.nin_shortcut.weight",
                "encoder.down.0.downsample.conv.bias", "encoder.down.1.attn.0.proj_out.weight",
                "encoder.mid.attn_1.q.weight", "encoder.norm_out.bias", "decoder.mid.block_2.conv2.weight",
                "decoder.up.1.upsample.conv.weight", "decoder.up.0.block.1.norm2.bias",
                "decoder.conv_out.weight", "quant_conv.weight", "post_quant_conv.bias",
                "quantize.embedding.weight"):
        assert key in sd, key
    assert sd["encoder.conv_in.weight"].shape == (8, 3, 3, 3)
    # what the JAX package's own converter makes of the port's state_dict
    back = jconvert.convert_vqgan_params(sd, cfg)
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(flat_back) == len(flat_want)
    for path, leaf in flat_back:
        np.testing.assert_array_equal(leaf, flat_want[path])
    again = convert.v2_vqgan_to_flax(sd, tvqgan.VQGANConfig.tiny())
    for path, leaf in jax.tree_util.tree_leaves_with_path(again):
        np.testing.assert_array_equal(leaf, flat_want[path])


def test_full_width_vqgan_has_tamings_published_keys():
    """The ImageNet f16 16384 model, built without storage: the key set
    and shapes a published checkpoint (its ``loss.*`` entries dropped)
    loads into with ``strict=True``."""
    model = tvqgan.VQModel(tvqgan.VQGANConfig.imagenet_f16_16384(), device="meta")
    sd = model.state_dict()
    assert sd["quantize.embedding.weight"].shape == (16384, 256)
    assert sd["encoder.down.4.attn.1.k.weight"].shape == (512, 512, 1, 1)
    assert sd["decoder.up.4.attn.2.norm.weight"].shape == (512,)
    assert sd["decoder.up.3.block.0.nin_shortcut.weight"].shape == (256, 512, 1, 1)
    assert "encoder.down.4.downsample.conv.weight" not in sd and "decoder.up.0.upsample.conv.weight" not in sd
    assert sum(v.numel() for v in sd.values()) == 76_073_859
    assert tvqgan.config_from_yaml_dict({
        "embed_dim": 256, "n_embed": 16384, "ddconfig": {
            "z_channels": 256, "resolution": 256, "in_channels": 3, "out_ch": 3, "ch": 128,
            "ch_mult": [1, 1, 2, 2, 4], "num_res_blocks": 2, "attn_resolutions": [16], "dropout": 0.0,
        }}) == tvqgan.VQGANConfig.imagenet_f16_16384()


# ------------------------------------------------------------------ CLIP
@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_clip_towers_match_flax(clip_pair, dtype):
    cfg, params, sd = clip_pair
    jmodel = jclip.CLIP(cfg, dtype=None if dtype is None else jnp.bfloat16)
    port = _load(tclip.CLIP(tclip.CLIPConfig.tiny(), dtype, device="cpu"), sd)
    rng = np.random.default_rng(4)
    images = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
    tokens = np.zeros((3, 16), np.int32)
    for row, n in enumerate((5, 16, 9)):  # SOT ... EOT, the EOT id the largest
        tokens[row, :n] = [254, *rng.integers(1, 254, n - 2), 255]
    got = port.encode_image(torch.from_numpy(images))
    want = jmodel.apply({"params": params}, jnp.asarray(images), method=jclip.CLIP.encode_image)
    assert got.dtype == (dtype or torch.float32)
    _close(got, want, dtype)
    got = port.encode_text(torch.from_numpy(tokens))
    want = jmodel.apply({"params": params}, jnp.asarray(tokens), method=jclip.CLIP.encode_text)
    _close(got, want, dtype)


def test_clip_image_gradient_matches_flax(clip_pair):
    cfg, params, sd = clip_pair
    port = _load(tclip.CLIP(tclip.CLIPConfig.tiny(), device="cpu"), sd).requires_grad_(False)
    rng = np.random.default_rng(5)
    images = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    cot = rng.normal(size=(2, 16)).astype(np.float32)
    leaf = torch.from_numpy(images).requires_grad_(True)
    port.encode_image(leaf).backward(torch.from_numpy(cot))
    _, vjp = jax.vjp(lambda a: jclip.CLIP(cfg).apply({"params": params}, a, method=jclip.CLIP.encode_image),
                     jnp.asarray(images))
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]), rtol=1e-4, atol=1e-4)


def test_clip_state_dict_has_openais_names_and_round_trips(clip_pair):
    cfg, params, sd = clip_pair
    port = tclip.CLIP(tclip.CLIPConfig.tiny(), device="cpu")
    assert set(port.state_dict()) == set(sd)
    for key in ("visual.conv1.weight", "visual.class_embedding", "visual.positional_embedding",
                "visual.ln_pre.weight", "visual.transformer.resblocks.1.attn.in_proj_weight",
                "visual.transformer.resblocks.0.attn.out_proj.bias",
                "visual.transformer.resblocks.0.mlp.c_fc.weight", "visual.ln_post.bias", "visual.proj",
                "token_embedding.weight", "positional_embedding", "ln_final.weight", "text_projection",
                "transformer.resblocks.1.mlp.c_proj.weight", "transformer.resblocks.0.ln_2.bias"):
        assert key in sd, key
    assert sd["visual.conv1.weight"].shape == (16, 3, 8, 8)
    assert sd["visual.transformer.resblocks.0.attn.in_proj_weight"].shape == (48, 16)
    assert tclip.clip_config_from_state_dict(sd) == tclip.CLIPConfig(
        **{f.name: getattr(jconvert.clip_config_from_state_dict(sd), f.name)
           for f in dataclasses.fields(tclip.CLIPConfig)})
    back = jconvert.convert_clip_params(sd, cfg)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(params))
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    assert len(flat_back) == len(flat_want)
    for path, leaf in flat_back:
        np.testing.assert_array_equal(leaf, flat_want[path])
    for path, leaf in jax.tree_util.tree_leaves_with_path(convert.v2_clip_to_flax(sd, tclip.CLIPConfig.tiny())):
        np.testing.assert_array_equal(leaf, flat_want[path])


def test_full_width_clip_has_openais_published_keys_and_config():
    model = tclip.CLIP(tclip.CLIPConfig.vit_b32(), device="meta")
    sd = model.state_dict()
    assert sd["visual.conv1.weight"].shape == (768, 3, 32, 32)
    assert sd["visual.positional_embedding"].shape == (50, 768)
    assert sd["transformer.resblocks.11.attn.in_proj_weight"].shape == (1536, 512)
    assert sd["token_embedding.weight"].shape == (49408, 512)
    assert sd["text_projection"].shape == (512, 512)
    # OpenAI's ViT-B/32 has 151,277,313 parameters with its logit_scale
    assert sum(v.numel() for v in sd.values()) == 151_277_312
    assert tclip.clip_config_from_state_dict(sd) == tclip.CLIPConfig.vit_b32()


@pytest.mark.parametrize("preset", ["vit_b32", "vit_b16", "vit_l14", "vit_l14_336", "rn50", "rn101",
                                    "rn50x4", "rn50x16", "rn50x64", "tiny"])
def test_clip_presets_are_the_jax_packages(preset):
    got, want = getattr(tclip.CLIPConfig, preset)(), getattr(jclip.CLIPConfig, preset)()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.is_resnet == want.is_resnet
    if got.is_resnet:  # builds, and its state_dict gives the preset back
        sd = tclip.CLIP(got, device="meta").state_dict()
        assert tclip.clip_config_from_state_dict(sd) == got


def test_quick_gelu_and_normalize_image_match_jax():
    x = np.random.default_rng(6).normal(size=(4, 5, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(tclip.quick_gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jclip.quick_gelu(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tclip.normalize_image(torch.from_numpy(x)).numpy(),
                               np.asarray(jclip.normalize_image(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
