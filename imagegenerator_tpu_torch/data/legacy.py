"""Legacy local data path — the GloVe / LSTM captions, counterpart of
``imagegenerator_tpu/data/legacy.py`` (plain numpy, the port's own copy).

A local COCO dataset's captions numericalized against a GloVe vocabulary
(an appended ``<UNK>`` = the mean vector and ``<PAD>`` = zeros) and
padded to a fixed length, feeding ``models/text_lstm.py``'s
``TextEmbeddingLSTM``. Words come from a regular-expression tokenizer
(lowercase words and single punctuation marks); GloVe vectors load from a
local ``glove.6B.300d.txt``-style file, or ``Vocabulary.synthetic`` makes
seeded stand-ins for tests. Every batch pads to ``max_length``, so every
batch has one shape.
"""

from __future__ import annotations

import re

import numpy as np

_WORD_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]")


def tokenize(text: str) -> list[str]:
    return _WORD_RE.findall(text.lower())


class Vocabulary:
    """GloVe-backed vocabulary with <UNK> (mean vector) and <PAD> (zeros)."""

    def __init__(self, stoi: dict[str, int], vectors: np.ndarray):
        vectors = np.asarray(vectors, np.float32)
        unk = vectors.mean(axis=0, keepdims=True)
        pad = np.zeros((1, vectors.shape[1]), np.float32)
        self.vectors = np.concatenate([vectors, unk, pad], axis=0)
        self.stoi = dict(stoi)
        self.unk_index = len(vectors)
        self.pad_index = len(vectors) + 1
        self.stoi["<UNK>"] = self.unk_index
        self.stoi["<PAD>"] = self.pad_index

    def __len__(self) -> int:
        return len(self.vectors)

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    def numericalize(self, text: str) -> list[int]:
        return [self.stoi.get(tok, self.unk_index) for tok in tokenize(text)]

    @classmethod
    def from_glove_file(cls, path: str, max_words: int | None = None) -> "Vocabulary":
        """Parse a ``word v1 v2 ...`` per-line GloVe text file."""
        stoi: dict[str, int] = {}
        vecs: list[np.ndarray] = []
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip().split(" ")
                if len(parts) < 2:
                    continue
                stoi[parts[0]] = len(vecs)
                vecs.append(np.asarray(parts[1:], np.float32))
                if max_words and len(vecs) >= max_words:
                    break
        return cls(stoi, np.stack(vecs))

    @classmethod
    def synthetic(
        cls, words: list[str], dim: int = 300, seed: int = 0
    ) -> "Vocabulary":
        """Deterministic random vectors — the test stand-in for GloVe."""
        rng = np.random.default_rng(seed)
        vectors = rng.standard_normal((len(words), dim)).astype(np.float32)
        return cls({w: i for i, w in enumerate(words)}, vectors)


class LegacyCollate:
    """captions -> fixed-shape int32 token batch padded with <PAD>."""

    def __init__(self, vocab: Vocabulary, max_length: int = 64):
        self.vocab = vocab
        self.max_length = max_length

    def __call__(self, texts: list[str]) -> dict[str, np.ndarray]:
        out = np.full((len(texts), self.max_length), self.vocab.pad_index, np.int32)
        for i, text in enumerate(texts):
            ids = self.vocab.numericalize(text)[: self.max_length]
            out[i, : len(ids)] = ids
        return {"input_ids": out}
