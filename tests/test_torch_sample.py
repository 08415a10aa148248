"""The port's sampling slice against the JAX package's own ``sample``, in
f32 on the CPU at the tiny configs: ``Stage2System.sample`` (tokens ->
BERT -> projection -> CA1 -> G1 -> CA2 -> G2) and ``Stage1System.sample``,
each from a token batch and from a precomputed ``tem`` batch, with JAX's
noise draws recovered and injected; the converter's round trip; and the
sampling CLI end to end.

Tolerance: rtol = atol = 1e-4 (the whole slice)."""

import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from PIL import Image

from imagegenerator_tpu.train import stage1 as js1
from imagegenerator_tpu.train import stage2 as js2
from imagegenerator_tpu_torch import convert
from imagegenerator_tpu_torch.models.bert import BertConfig
from imagegenerator_tpu_torch.train import sample
from imagegenerator_tpu_torch.train import stage1 as ts1
from imagegenerator_tpu_torch.train import stage2 as ts2
from imagegenerator_tpu_torch.utils.png import encode_png

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
FIELDS = {1: ("params", "batch_stats"),
          2: ("frozen_params", "frozen_gen_stats", "params", "batch_stats")}


def _jax_state(stage, seed=0, batch=4):
    """A tiny JAX system and state with its BatchNorm statistics and
    affine parameters redrawn (so eval mode is not the identity), and
    the state as the flat ``<field>/<flax path>`` dict."""
    system = js1.Stage1System(js1.Stage1Config.tiny()) if stage == 1 else js2.Stage2System(js2.Stage2Config.tiny())
    state = system.init(jax.random.key(seed), batch)
    rng = np.random.default_rng(seed)
    flat, fields = {}, {}
    for field in FIELDS[stage]:
        leaves = {}
        for path, leaf in traverse_util.flatten_dict(getattr(state, field)).items():
            a = np.asarray(leaf)
            if "bn" in path:
                a = (rng.uniform(0.5, 2.0, a.shape) if path[-1] == "var"
                     else a + 0.3 * rng.standard_normal(a.shape)).astype(np.float32)
            leaves[path] = a
            flat[field + "/" + "/".join(path)] = a
        fields[field] = traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in leaves.items()})
    return system, state.replace(**fields), flat


def _eps(ca, params, tem, key):
    """The eps a ConditioningAugmentation draws under ``rngs={'noise': key}``."""
    return ca.apply(
        {"params": params}, tem, rngs={"noise": key},
        method=lambda m, t: jax.random.normal(m.make_rng("noise"), (t.shape[0], m.c_dim)),
    )


def _check_eps_reproduces_c_hat(ca, params, tem, key, eps):
    c_hat, _, _ = ca.apply({"params": params}, tem, rngs={"noise": key})
    mu, sigma = ca.apply({"params": params}, tem, method=lambda m, t: m.encode(t))
    np.testing.assert_array_equal(np.asarray(mu + sigma * eps), np.asarray(c_hat))


def _batch(system, route, B=4, seed=7):
    rng = np.random.default_rng(seed)
    T = system.config.seq_len
    if route == "tem":
        return {"tem": rng.standard_normal((B, system.config.tem_size)).astype(np.float32)}
    mask = np.ones((B, T), np.int32)
    mask[1, T // 2:] = 0
    mask[2, 3:] = 0
    return {"input_ids": rng.integers(0, 128, (B, T)).astype(np.int32), "attention_mask": mask}


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("route", ["tokens", "tem"])
def test_stage2_sample_matches_jax(route, fused):
    system, state, flat = _jax_state(2)
    batch = _batch(system, route)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.key(456)
    want = system.sample(state, jbatch, key)

    k_ca1, k_z, k_ca2 = jax.random.split(key, 3)
    if route == "tem":
        tem = jbatch["tem"]
    else:
        tem = system.embed_texts(state, jbatch["input_ids"], jbatch["attention_mask"])
    fp = state.frozen_params
    eps1 = _eps(system.con_augment_1, fp["con_augment_1"], tem, k_ca1)
    eps2 = _eps(system.con_augment_2, state.params["con_augment_2"], tem, k_ca2)
    _check_eps_reproduces_c_hat(system.con_augment_1, fp["con_augment_1"], tem, k_ca1, eps1)
    _check_eps_reproduces_c_hat(system.con_augment_2, state.params["con_augment_2"], tem, k_ca2, eps2)
    z = jax.random.normal(k_z, (tem.shape[0], system.config.z_dim), jnp.float32)
    noise = {k: torch.from_numpy(np.array(v)) for k, v in
             {"ca1_eps": eps1, "z": z, "ca2_eps": eps2}.items()}

    bert_cfg = dataclasses.replace(BertConfig.tiny(), fused_attention=fused, fused_ln=fused)
    cfg = ts2.Stage2Config.tiny(bert=bert_cfg)
    port = convert.stage2_from_numpy(flat, cfg, "cpu")
    got = port.sample({k: torch.from_numpy(v) for k, v in batch.items()}, noise=noise)
    assert tuple(got.shape) == (4, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if route == "tokens":
        tem_port = port.embed_texts(torch.from_numpy(batch["input_ids"]), torch.from_numpy(batch["attention_mask"]))
        np.testing.assert_allclose(tem_port.detach().numpy(), np.asarray(tem), **TOL)


@pytest.mark.parametrize("route", ["tokens", "tem"])
def test_stage1_sample_matches_jax(route):
    system, state, flat = _jax_state(1, seed=3)
    batch = _batch(system, route, seed=8)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.key(12)
    want = system.sample(state, jbatch, key)

    k_ca, k_z = jax.random.split(key)
    if route == "tem":
        tem = jbatch["tem"]
    else:
        tem = system.encode_text(state.params["encoder"], state.params["projection"],
                                 jbatch["input_ids"], jbatch["attention_mask"], dropout_key=None)
    eps = _eps(system.con_augment, state.params["con_augment"], tem, k_ca)
    _check_eps_reproduces_c_hat(system.con_augment, state.params["con_augment"], tem, k_ca, eps)
    z = jax.random.normal(k_z, (tem.shape[0], system.config.z_dim), jnp.float32)

    port = convert.stage1_from_numpy(flat, ts1.Stage1Config.tiny(), "cpu")
    noise = {"ca_eps": torch.from_numpy(np.array(eps)), "z": torch.from_numpy(np.array(z))}
    got = port.sample({k: torch.from_numpy(v) for k, v in batch.items()}, noise=noise)
    assert tuple(got.shape) == (4, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("stage", [1, 2])
def test_convert_round_trip_is_exact(stage):
    _, _, flat = _jax_state(stage, seed=5)
    if stage == 1:
        back = convert.to_numpy(convert.stage1_from_numpy(flat, ts1.Stage1Config.tiny()))
    else:
        back = convert.stage2_to_numpy(convert.stage2_from_numpy(flat, ts2.Stage2Config.tiny()))
    critic = {k for k in flat if "critic" in k}
    assert set(back) == set(flat) - critic
    for k, v in back.items():
        assert v.dtype == flat[k].dtype and np.array_equal(v, flat[k]), k


def test_noise_order_follows_jax():
    """Drawn from one generator: CA1 eps, then z, then CA2 eps."""
    port = ts2.Stage2System(ts2.Stage2Config.tiny(), generator=torch.Generator().manual_seed(0))
    batch = {"tem": torch.randn(3, 32)}
    gen = torch.Generator().manual_seed(11)
    drawn = [torch.randn((3, 16), generator=gen), torch.randn((3, 12), generator=gen),
             torch.randn((3, 16), generator=gen)]
    a = port.sample(batch, generator=torch.Generator().manual_seed(11))
    b = port.sample(batch, noise=dict(zip(("ca1_eps", "z", "ca2_eps"), drawn)))
    assert torch.equal(a, b)


def _write_ckpt(tmp_path, stage):
    _, _, flat = _jax_state(stage, seed=9)
    (tmp_path / "ck" / f"Stage{stage}").mkdir(parents=True)
    np.savez(tmp_path / "ck" / f"Stage{stage}" / "params.npz", **flat)
    return flat


@pytest.mark.parametrize("stage", [1, 2])
def test_sample_cli(tmp_path, capsys, stage):
    flat = _write_ckpt(tmp_path, stage)
    out = tmp_path / "out"
    sample.main([
        "--stage", str(stage), "--tiny", "--device", "cpu",
        "--checkpoint_dir", str(tmp_path / "ck"),
        "--caption", "a red bus|a snowy street", "-n", "2", "-o", str(out),
        "--seed", "3", "--fused_attn", "--fused_ln",
    ])
    files = sorted(p.name for p in out.iterdir())
    assert files == ["sample_0_0.png", "sample_0_1.png", "sample_1_0.png", "sample_1_1.png"]
    res = 16 if stage == 1 else 32
    img = Image.open(out / "sample_1_0.png")
    assert img.size == (res, res) and img.mode == "RGB"
    assert img.text["comment"] == "a snowy street"
    stdout = capsys.readouterr().out
    assert f"wrote {out / 'sample_1_1.png'} ({res}x{res}): a snowy street" in stdout

    # the PNGs hold the port's own sample from the same seed
    from imagegenerator_tpu_torch.data.tokenizer import HashTokenizer

    cfg = ts1.Stage1Config.tiny() if stage == 1 else ts2.Stage2Config.tiny()
    system = (convert.stage1_from_numpy if stage == 1 else convert.stage2_from_numpy)(flat, cfg)
    texts = ["a red bus", "a red bus", "a snowy street", "a snowy street"]
    batch = {k: torch.from_numpy(v) for k, v in HashTokenizer(128, cfg.seq_len)(texts).items()}
    imgs = system.sample(batch, generator=torch.Generator().manual_seed(3))
    want = ((imgs + 1) * 127.5 + 0.5).clamp(0, 255).to(torch.uint8).numpy()
    np.testing.assert_array_equal(np.asarray(Image.open(out / "sample_1_0.png")), want[2])
    assert not np.array_equal(want[0], want[1])


def test_sample_cli_refusals(tmp_path, monkeypatch):
    _write_ckpt(tmp_path, 2)
    base = ["--tiny", "--checkpoint_dir", str(tmp_path / "ck"), "--caption", "x"]
    with pytest.raises(SystemExit, match="--ema"):
        sample.main(base + ["--device", "cpu", "--ema"])
    with pytest.raises(SystemExit, match="no checkpoint"):
        sample.main(base + ["--device", "cpu", "--stage", "1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        sample.main(base)


@pytest.mark.parametrize("text", ["a red bus", "ünïcode café ☕"])
def test_png_writer_round_trips_through_pillow(text):
    rgb = np.random.default_rng(0).integers(0, 256, (5, 7, 3)).astype(np.uint8)
    img = Image.open(io.BytesIO(encode_png(rgb, {"comment": text})))
    img.load()
    assert img.mode == "RGB" and img.size == (7, 5)
    np.testing.assert_array_equal(np.asarray(img), rgb)
    assert img.text["comment"] == text
