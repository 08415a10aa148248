"""Offline caption-embedding cache for stage-2 training — the port's own
copy of ``imagegenerator_tpu/data/text_cache.py``.

The stage-2 text encoder is frozen, so every caption's embedding is a
constant. ``precompute_caption_embeddings`` embeds a dataset's captions
once, in batches, through the frozen encoder and projection
(``Stage2System.embed_texts``, under ``no_grad``) and caches the
``(N, tem_size)`` f32 table in the blob store, under the JAX package's key
(a blake2b hash of ``tem_size`` and the captions) and path
(``text_cache/<hash>.npy``), so a table either package cached is found by
the other. The loader then serves ``batch['tem']`` rows
(``PrecomputedTextDataset`` + ``TemCollate``) and the train step skips the
encoder.

The JAX function's ``params=`` argument is gone: it existed only to keep
the encoder's weights out of a jitted graph, where they would become
constants; an eager ``embed_fn`` holds its weights itself.
"""

from __future__ import annotations

import hashlib
import io

import numpy as np
import torch

from imagegenerator_tpu_torch.utils.device import entry_device


def cache_key(captions: list[str], tem_size: int) -> str:
    h = hashlib.blake2b(digest_size=16)
    h.update(str(tem_size).encode())
    for c in captions:
        h.update(c.encode("utf-8"))
        h.update(b"\0")
    return h.hexdigest()


def precompute_caption_embeddings(
    embed_fn,
    tokenizer,
    captions: list[str],
    tem_size: int,
    *,
    batch_size: int = 256,
    store=None,
    cache_prefix: str = "text_cache",
    device=None,
) -> np.ndarray:
    """Every caption through ``embed_fn(tokens, mask) -> (B, tem_size)``
    (e.g. ``Stage2System.embed_texts``), ``batch_size`` at a time, the
    ragged tail padded with empty captions so that every call has one
    shape. Tokens go to ``device`` (the card unless another is named).

    With a ``store`` the table is read from, or written to,
    ``<cache_prefix>/<cache_key>.npy``, so a repeated or resumed run skips
    the sweep."""
    cache_path = None
    if store is not None:
        cache_path = f"{cache_prefix}/{cache_key(captions, tem_size)}.npy"
        if store.exists(cache_path):
            return np.load(io.BytesIO(store.read_bytes(cache_path)))

    dev = entry_device(device)
    out = np.zeros((len(captions), tem_size), np.float32)
    with torch.no_grad():
        for start in range(0, len(captions), batch_size):
            chunk = captions[start:start + batch_size]
            toks = tokenizer(chunk + [""] * (batch_size - len(chunk)))
            ids = torch.from_numpy(np.asarray(toks["input_ids"])).to(dev)
            mask = torch.from_numpy(np.asarray(toks["attention_mask"])).to(dev)
            tem = embed_fn(ids, mask)
            out[start:start + len(chunk)] = tem[:len(chunk)].float().cpu().numpy()

    if cache_path is not None:
        buf = io.BytesIO()
        np.save(buf, out)
        store.write_bytes(cache_path, buf.getvalue())
    return out


class PrecomputedTextDataset:
    """Wraps a (caption, image) dataset so that samples carry the cached
    embedding row instead of the text: ``__getitem__ -> (tem, image)``."""

    def __init__(self, dataset, tem_table: np.ndarray):
        if len(dataset) != len(tem_table):
            raise ValueError(f"embedding table has {len(tem_table)} rows for {len(dataset)} samples")
        self.dataset = dataset
        self.tem_table = tem_table

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, index: int):
        _, image = self.dataset[index]
        return self.tem_table[index], image


class TemCollate:
    """The loader's tokenizer role for precomputed embeddings: stacks the
    rows into ``{'tem': (B, tem_size)}`` of ``dtype``, a numpy dtype or a
    torch one. numpy has no bfloat16, so a torch dtype (the JAX package's
    ``TemCollate(dtype=bfloat16)``: the step's compute dtype crosses the
    link) collates into a torch tensor, rounded to nearest even as
    ``ml_dtypes`` rounds, in pinned memory where there is a card."""

    def __init__(self, dtype=np.float32):
        self.dtype = dtype

    def __call__(self, tems: list[np.ndarray]) -> dict:
        stacked = np.stack(tems)
        if not isinstance(self.dtype, torch.dtype):
            return {"tem": stacked.astype(self.dtype)}
        out = torch.empty(stacked.shape, dtype=self.dtype, pin_memory=torch.cuda.is_available())
        return {"tem": out.copy_(torch.from_numpy(stacked.astype(np.float32, copy=False)))}
