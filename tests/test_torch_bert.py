"""Parity of the port's BERT encoder with the JAX package's, in f32 on the
CPU, with ``fused_attention`` and ``fused_ln`` each off and on (on the
JAX side the Pallas kernels run in interpret mode; on the port's side a
CPU tensor takes each kernel's plain version); loading an HF-named
``state_dict`` (the ``THFBert`` oracle of ``test_bert_convert.py``)
unchanged; and the hash tokenizer's ids.

Tolerance: rtol = atol = 1e-4 (a BERT stack)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagegenerator_tpu.data.tokenizer import HashTokenizer as JHashTokenizer
from imagegenerator_tpu.models import bert as jbert
from imagegenerator_tpu.ops.pallas import attention as jattn
from imagegenerator_tpu_torch import convert
from imagegenerator_tpu_torch.data.tokenizer import HashTokenizer
from imagegenerator_tpu_torch.models import bert as tbert
from tests.test_bert_convert import THFBert
from tests.test_torch_layers import flat_variables, grid_input

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
CONFIGS = {
    "tiny": (dict(vocab_size=128, hidden_size=16, num_layers=1, num_heads=2,
                  intermediate_size=32, max_position_embeddings=64), 3, 8),
    "base_2layer": (dict(vocab_size=128, num_layers=2, max_position_embeddings=128), 2, 128),
    # T % 8 != 0: off the JAX fused path's shapes, so on the CPU both
    # encoders take their einsum attention even with fused_attention set
    "tiny_T11": (dict(vocab_size=128, hidden_size=16, num_layers=1, num_heads=2,
                      intermediate_size=32, max_position_embeddings=64), 3, 11),
    # 8 heads of 32: a head dim the card's kernels took only from when they
    # took every head dim of the JAX fused path
    "h8x32": (dict(vocab_size=128, hidden_size=256, num_layers=2, num_heads=8,
                   intermediate_size=64, max_position_embeddings=64), 3, 24),
}


def _batch(cfg, B, T, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[1, T // 2:] = 0
    mask[-1, 3:] = 0
    return ids, mask


@pytest.mark.parametrize("fused_ln", [False, True])
@pytest.mark.parametrize("fused_attention", [False, True])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_encoder_matches_jax(name, fused_attention, fused_ln):
    kw, B, T = CONFIGS[name]
    jcfg = jbert.BertConfig(**kw, fused_attention=fused_attention, fused_ln=fused_ln)
    tcfg = tbert.BertConfig(**kw, fused_attention=fused_attention, fused_ln=fused_ln)
    ids, mask = _batch(tcfg, B, T)
    jenc = jbert.BertEncoder(jcfg)
    variables = jenc.init(jax.random.key(0), jnp.asarray(ids), jnp.asarray(mask))
    want = jenc.apply(variables, jnp.asarray(ids), jnp.asarray(mask), deterministic=True)
    enc = tbert.BertEncoder(tcfg)
    convert.load_numpy(enc, flat_variables(variables))
    with torch.no_grad():
        got = enc(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shift,step", [(0.0, None), (30.0, 0.125)])
def test_unfused_layernorm_is_flax_layernorm(shift, step, dtype):
    """Without fused_ln, BERT's LayerNorm is flax nn.LayerNorm's formula
    (fast variance), not the kernel's two-pass one. At shift 30 the input
    is on a grid whose sums are exact in f32 (see
    ``test_torch_layers.grid_input``), where the two-pass formula reads
    1.7e-4."""
    from flax import linen as fnn

    rng = np.random.default_rng(9)
    if step is None:
        x = (rng.standard_normal((6, 5, 64)) * 0.5 + shift).astype(np.float32)
    else:
        x = grid_input((6, 5, 64), shift, step, 9)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    xj = jnp.asarray(x, jdt)
    ln = fnn.LayerNorm(epsilon=1e-12)
    variables = ln.init(jax.random.key(0), xj)
    variables = {"params": {"scale": jnp.asarray(1 + 0.1 * rng.standard_normal(64), jnp.float32),
                            "bias": jnp.asarray(0.1 * rng.standard_normal(64), jnp.float32)}}
    want = ln.apply(variables, xj)
    port = tbert.LayerNorm(64, 1e-12)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.asarray(variables["params"]["scale"])))
        port.bias.copy_(torch.from_numpy(np.asarray(variables["params"]["bias"])))
        got = port(torch.from_numpy(np.array(xj, np.float32)).to(tdt))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_bf16_residual_stream_is_f32_after_layer_0():
    """The JAX dtype flow: compute dtype into layer 0, and every
    LayerNorm returns promote(x, f32 scale) = f32."""
    cfg = tbert.BertConfig.tiny()
    enc = tbert.BertEncoder(dataclasses.replace(cfg, num_layers=2), dtype=torch.bfloat16)
    seen = []
    for layer in enc.encoder.layer:
        layer.register_forward_pre_hook(lambda m, a: seen.append(a[0].dtype))
    ids, mask = _batch(cfg, 2, 8)
    out = enc(torch.from_numpy(ids), torch.from_numpy(mask))
    assert seen == [torch.bfloat16, torch.float32] and out.dtype == torch.float32


@pytest.mark.parametrize("prefix", ["", "bert."])
def test_hf_state_dict_loads_unchanged(prefix):
    cfg = tbert.BertConfig(vocab_size=100, hidden_size=128, num_layers=2, num_heads=2,
                           intermediate_size=64, max_position_embeddings=32)
    oracle = THFBert(cfg).eval()
    ids, mask = _batch(cfg, 3, 12, seed=1)
    ids_t, mask_t = torch.from_numpy(ids).long(), torch.from_numpy(mask).long()
    with torch.no_grad():
        want = oracle(ids_t, mask_t).numpy()
    enc = tbert.BertEncoder(cfg)
    enc.load_state_dict(oracle.state_dict())
    with torch.no_grad():
        np.testing.assert_allclose(enc(ids_t, mask_t).numpy(), want, **TOL)

    sd = {f"{prefix}{k}": v for k, v in oracle.state_dict().items()}
    sd[f"{prefix}pooler.dense.weight"] = torch.zeros(128, 128)
    want_cfg = jbert.config_from_state_dict(sd)
    assert dataclasses.asdict(tbert.config_from_state_dict(sd)) == dataclasses.asdict(want_cfg)
    loaded = tbert.BertEncoder(tbert.config_from_state_dict(sd))
    loaded.load_state_dict(tbert.strip_prefix(sd))
    with torch.no_grad():
        np.testing.assert_allclose(loaded(ids_t, mask_t).numpy(), want, **TOL)


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_flavours_match_jax(approximate):
    kw, B, T = CONFIGS["tiny"]
    jenc = jbert.BertEncoder(jbert.BertConfig(**kw, gelu_approximate=approximate))
    ids, mask = _batch(tbert.BertConfig(**kw), B, T, seed=2)
    variables = jenc.init(jax.random.key(1), jnp.asarray(ids), jnp.asarray(mask))
    want = jenc.apply(variables, jnp.asarray(ids), jnp.asarray(mask))
    enc = tbert.BertEncoder(tbert.BertConfig(**kw, gelu_approximate=approximate))
    convert.load_numpy(enc, flat_variables(variables))
    with torch.no_grad():
        got = enc(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("hidden,heads,T,card,cpu", [
    (768, 12, 128, True, True), (256, 8, 24, True, True), (16, 2, 8, True, True),
    (768, 12, 77, True, False),   # any T on the card; T % 8 on the CPU, as in JAX
    (768, 12, 520, True, True),
    (80, 4, 16, False, False),    # head dim 20: einsum attention everywhere, as in JAX
    (96, 3, 16, True, True), (768, 7, 16, False, False),
])
def test_fused_route_follows_the_jax_domain(hidden, heads, T, card, cpu):
    """``fused_attention`` takes the kernels on the card wherever they take
    the head dim (the JAX fused path's, at any T) and on the CPU where the
    JAX package's ``supported`` does; elsewhere both packages run the
    einsum attention."""
    cfg = tbert.BertConfig(hidden_size=hidden, num_heads=heads, fused_attention=True)
    assert tbert._fused(cfg, True, T) == card
    assert tbert._fused(cfg, False, T) == cpu == jattn.supported(T, hidden, heads)
    assert not tbert._fused(dataclasses.replace(cfg, fused_attention=False), True, T)


def test_config_defaults_match_jax():
    assert dataclasses.asdict(tbert.BertConfig()) == dataclasses.asdict(jbert.BertConfig())
    assert dataclasses.asdict(tbert.BertConfig.tiny()) == dataclasses.asdict(jbert.BertConfig.tiny())


@pytest.mark.parametrize("vocab,max_len", [(28996, 128), (128, 8), (1000, 16)])
def test_hash_tokenizer_ids_identical(vocab, max_len):
    texts = [
        "a red bus on a street",
        "Two DOGS, running; on the beach!!",
        "ünïcode café — naïve résumé",
        "",
        " ".join(f"word{i}" for i in range(200)),
        "numbers 123 and 4.56 and a-b_c",
    ]
    got = HashTokenizer(vocab, max_len)(texts)
    want = JHashTokenizer(vocab, max_len)(texts)
    for key in ("input_ids", "attention_mask"):
        assert got[key].dtype == np.int32
        np.testing.assert_array_equal(got[key], want[key])
