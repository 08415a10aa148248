"""The port's caption-embedding cache (``data/text_cache.py``) against the
JAX package's, on the CPU at ``Stage2Config.tiny()``: the same cache key
and path, so a table either package wrote to a store is read by the other
without an encoder sweep; from the same weights (a JAX init carried over
by ``convert``) the two sweeps give the same table to 1e-4 (f32; the
ragged tail padded the same way); and the stage-2 trainer trains on
``PrecomputedTextDataset`` + ``TemCollate`` batches, sample grids
included, as the JAX test of its trainer does."""

import io
import json

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from imagegenerator_tpu import data as jdata
from imagegenerator_tpu.data import text_cache as jcache
from imagegenerator_tpu.train import stage2 as js2
from imagegenerator_tpu_torch import convert
from imagegenerator_tpu_torch.data import coco, storage, text_cache
from imagegenerator_tpu_torch.data.pipeline import DataLoader
from imagegenerator_tpu_torch.data.tokenizer import HashTokenizer
from imagegenerator_tpu_torch.train import stage2 as ts2
from imagegenerator_tpu_torch.train.trainer import Stage2Trainer, TrainerOptions
from tests.test_torch_stage1_step import jax_flat

torch.set_num_threads(2)
FIELDS = ("frozen_params", "frozen_gen_stats", "params", "batch_stats")
CAPTIONS = [f"caption number {i}, {'long ' * i}tail" for i in range(5)]


@pytest.fixture(scope="module")
def carried():
    """A JAX tiny stage-2 state, and the port's system holding its
    weights."""
    cfg = js2.Stage2Config.tiny()
    system = js2.Stage2System(cfg)
    state = jax.jit(system.init, static_argnums=1)(jax.random.key(0), 2)
    port = convert.stage2_from_numpy(jax_flat(state, FIELDS), ts2.Stage2Config.tiny(), "cpu")
    return system, state, port


def _never(*_):
    raise AssertionError("the encoder ran although the table was cached")


def test_a_table_either_package_cached_is_read_by_the_other(tmp_path):
    tem = 32
    ours, theirs = storage.LocalStore(str(tmp_path)), jdata.LocalStore(str(tmp_path))
    assert text_cache.cache_key(CAPTIONS, tem) == jcache._cache_key(CAPTIONS, tem)
    table = np.random.default_rng(0).standard_normal((5, tem)).astype(np.float32)
    buf = io.BytesIO()
    np.save(buf, table)
    theirs.write_bytes(f"text_cache/{jcache._cache_key(CAPTIONS, tem)}.npy", buf.getvalue())
    got = text_cache.precompute_caption_embeddings(_never, None, CAPTIONS, tem, store=ours, device="cpu")
    np.testing.assert_array_equal(got, table)
    # and the other way: the port writes, JAX reads
    other = CAPTIONS[::-1]
    ones = lambda ids, mask: torch.ones((ids.shape[0], tem)) * ids[:, 1:2].float()
    tok = HashTokenizer(vocab_size=128, max_length=8)
    written = text_cache.precompute_caption_embeddings(ones, tok, other, tem, batch_size=2, store=ours,
                                                       device="cpu")
    assert sorted(p.name for p in (tmp_path / "text_cache").iterdir()) == sorted(
        f"{text_cache.cache_key(c, tem)}.npy" for c in (CAPTIONS, other))
    np.testing.assert_array_equal(jcache.precompute_caption_embeddings(_never, None, other, tem, store=theirs),
                                  written)
    assert written[:, 0].tolist() == [tok([c])["input_ids"][0, 1] for c in other]


@pytest.mark.parametrize("batch_size", [2, 8])
def test_tables_match_jax_from_carried_weights(carried, batch_size):
    system, state, port = carried
    cfg = system.config
    tok = HashTokenizer(vocab_size=cfg.bert.vocab_size, max_length=cfg.seq_len)
    jtok = jdata.HashTokenizer(vocab_size=cfg.bert.vocab_size, max_length=cfg.seq_len)
    want = jcache.precompute_caption_embeddings(lambda i, m: system.embed_texts(state, i, m), jtok, CAPTIONS,
                                                cfg.tem_size, batch_size=batch_size)
    got = text_cache.precompute_caption_embeddings(port.embed_texts, tok, CAPTIONS, cfg.tem_size,
                                                   batch_size=batch_size, device="cpu")
    assert got.shape == (5, cfg.tem_size) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    toks = tok(CAPTIONS[:2])
    direct = port.embed_texts(torch.from_numpy(toks["input_ids"]), torch.from_numpy(toks["attention_mask"]))
    np.testing.assert_allclose(got[:2], direct.numpy(), rtol=1e-5, atol=1e-6)


def _dataset(store, n=4):
    rng = np.random.default_rng(0)
    images, anns = [], []
    for i in range(n):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(buf, format="PNG")
        store.write_bytes(f"imgs/img{i}.png", buf.getvalue())
        images.append({"id": i, "file_name": f"img{i}.png"})
        anns.append({"image_id": i, "caption": f"caption number {i}"})
    store.write_text("ann/captions.json", json.dumps({"images": images, "annotations": anns}))


def test_stage2_trainer_runs_on_precomputed_embeddings(carried, tmp_path, capsys):
    _, _, port = carried
    store = storage.LocalStore(str(tmp_path / "ds"))
    _dataset(store)
    cfg = ts2.Stage2Config.tiny(n_critic=1)
    system = ts2.Stage2System(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    system.load_state_dict(port.state_dict())
    ds = coco.CocoCaptions(store, "imgs", "ann/captions.json", image_size=cfg.resolution)
    tok = HashTokenizer(vocab_size=cfg.bert.vocab_size, max_length=cfg.seq_len)
    table = text_cache.precompute_caption_embeddings(system.embed_texts, tok, [e.caption for e in ds.entries],
                                                     cfg.tem_size, batch_size=2, store=store, device="cpu")
    loader = DataLoader(text_cache.PrecomputedTextDataset(ds, table), text_cache.TemCollate(), batch_size=2,
                        num_workers=2, device="cpu")
    batch = next(iter(loader))
    assert set(batch) == {"tem", "image"} and batch["tem"].shape == (2, cfg.tem_size)
    sampled = []
    trainer = Stage2Trainer(system, loader, TrainerOptions(num_epochs=1, sample_every_steps=1, seed=3))
    trainer.writer.images = lambda step, tag, images: sampled.append((step, tag, images.shape))
    trainer.fit(trainer.init_state())
    assert system.step == 2
    assert sampled == [(1, "fake_256", (2, 32, 32, 3)), (1, "real_256", (2, 32, 32, 3))]
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("step ")]
    assert len(lines) == 2 and all("stage2/loss_critic" in l for l in lines)
    with pytest.raises(ValueError, match="rows"):
        text_cache.PrecomputedTextDataset(ds, table[:3])
    assert text_cache.TemCollate(np.float16)([table[0], table[1]])["tem"].dtype == np.float16


def test_bf16_collate_is_jax_bf16_collate_bit_for_bit():
    """``TemCollate(torch.bfloat16)`` (the ``e2e`` bench's transfer in
    bf16) rounds as the JAX package's ``TemCollate(bfloat16)``: the same
    bits for every row, ties to even included, and the loader takes the
    torch tensor as it comes."""
    import ml_dtypes

    rng = np.random.default_rng(0)
    rows = list(rng.standard_normal((6, 512)).astype(np.float32) * np.float32(3.0))
    # exact ties between two bf16 values, both parities, signs, tiny and huge values
    ties = np.array([0x3F808000, 0x3F818000, 0xBF808000, 0x00018000, 0x7F7F8000, 0x7F7FFFFF],
                    np.uint32).view(np.float32)
    rows.append(np.resize(np.concatenate([ties, [0.0, -0.0, np.inf, -np.inf, 1e-40, 3.4e38]]), 512)
                .astype(np.float32))
    got = text_cache.TemCollate(torch.bfloat16)(rows)["tem"]
    want = jcache.TemCollate(ml_dtypes.bfloat16)(rows)["tem"]
    assert got.dtype == torch.bfloat16 and want.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    loader = DataLoader([(r, np.zeros((4, 4, 3), np.uint8)) for r in rows], text_cache.TemCollate(torch.bfloat16),
                        batch_size=7, shuffle=False, num_workers=1, device="cpu")
    tem = next(iter(loader))["tem"]
    np.testing.assert_array_equal(tem.view(torch.int16).numpy(), want.view(np.int16))
