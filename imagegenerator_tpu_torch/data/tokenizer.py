"""Caption tokenizers producing fixed-shape ``(input_ids, attention_mask)``
— counterpart of ``imagegenerator_tpu/data/tokenizer.py``, re-implemented
here because importing the JAX package imports JAX. Ids are identical to
the JAX package's for every input.

* ``HashTokenizer`` — deterministic and dependency-free: lowercased
  word/punctuation tokens hashed (blake2b) into a fixed vocabulary, with
  CLS = 1, SEP = 2, PAD = 0.
* ``HFTokenizer`` — wraps a HuggingFace tokenizer from a local path;
  ``transformers`` is imported only when one is built.

Both return numpy int32 arrays of shape ``(B, max_length)``.
"""

from __future__ import annotations

import hashlib
import re

import numpy as np

_WORD_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]")


class HashTokenizer:
    CLS = 1
    SEP = 2
    PAD = 0
    _RESERVED = 3

    def __init__(self, vocab_size: int = 28996, max_length: int = 128):
        self.vocab_size = vocab_size
        self.max_length = max_length

    def _token_id(self, token: str) -> int:
        h = hashlib.blake2b(token.encode("utf-8"), digest_size=4).digest()
        return self._RESERVED + int.from_bytes(h, "little") % (
            self.vocab_size - self._RESERVED
        )

    def __call__(self, texts: list[str]) -> dict[str, np.ndarray]:
        n, L = len(texts), self.max_length
        ids = np.full((n, L), self.PAD, np.int32)
        mask = np.zeros((n, L), np.int32)
        for i, text in enumerate(texts):
            toks = _WORD_RE.findall(text.lower())[: L - 2]
            row = [self.CLS] + [self._token_id(t) for t in toks] + [self.SEP]
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return {"input_ids": ids, "attention_mask": mask}


class HFTokenizer:
    """HuggingFace tokenizer adapter (SpanBERT in production)."""

    def __init__(self, name_or_path: str, max_length: int = 128):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(name_or_path)
        self.max_length = max_length
        self.vocab_size = self._tok.vocab_size

    def __call__(self, texts: list[str]) -> dict[str, np.ndarray]:
        enc = self._tok(
            texts,
            padding="max_length",
            truncation=True,
            max_length=self.max_length,
            return_tensors="np",
        )
        return {
            "input_ids": enc["input_ids"].astype(np.int32),
            "attention_mask": enc["attention_mask"].astype(np.int32),
        }


def make_tokenizer(name: str | None, args_seq_len: int, cfg):
    """The tokenizer-selection rule of the JAX package's CLIs: an HF
    tokenizer uses the CLI ``--seq_len``; the hash tokenizer uses the
    model config's ``seq_len``. ``cfg`` needs ``.seq_len`` and
    ``.bert.vocab_size``."""
    if name:
        return HFTokenizer(name, max_length=args_seq_len)
    return HashTokenizer(vocab_size=cfg.bert.vocab_size, max_length=cfg.seq_len)
