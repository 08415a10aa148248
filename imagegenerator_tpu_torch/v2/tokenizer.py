"""CLIP text tokenizer — the port's own copy of
``imagegenerator_tpu/v2/tokenizer.py`` (numpy only).

OpenAI CLIP's ``clip.tokenize`` is a byte-level BPE over a 49,152-merge
vocabulary plus SOT/EOT framing to a fixed 77-token context.

``CLIPTokenizer`` implements that BPE given the standard
``bpe_simple_vocab_16e6.txt.gz`` merges file (a local path). When no
vocab file is available, ``FallbackTokenizer`` provides a deterministic
hash-vocab stand-in with the same framing and shape contract, so the
whole pipeline stays runnable and testable end to end.
"""

from __future__ import annotations

import functools
import gzip
import hashlib
import html
import re
import unicodedata

import numpy as np

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408
SOT = 49406
EOT = 49407

_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
_SPECIALS = ("<|startoftext|>", "<|endoftext|>")


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch).startswith("L")


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch).startswith("N")


def split_words(text: str) -> list:
    """Unicode-faithful equivalent of OpenAI CLIP's tokenization pattern

        ``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|
        [\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+``

    implemented as an explicit scanner over ``unicodedata`` categories
    (stdlib ``re`` has no ``\\p{..}`` classes): letter RUNS (any script),
    SINGLE number characters (Nd/Nl/No — wider than ``\\d``), contraction
    suffixes, and runs of everything else that isn't whitespace. Matches
    the vendored ``clip.tokenize`` word split on accented/CJK prompts
    (an ASCII-only pattern diverges there)."""
    out = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch.isspace():
            i += 1
            continue
        hit = next((s for s in _SPECIALS if text.startswith(s, i)), None)
        if hit is None:
            hit = next((c for c in _CONTRACTIONS if text.startswith(c, i)), None)
        if hit is not None:
            out.append(hit)
            i += len(hit)
            continue
        if _is_letter(ch):
            j = i + 1
            while j < n and _is_letter(text[j]):
                j += 1
        elif _is_number(ch):
            j = i + 1  # \p{N} matches ONE number character at a time
        else:
            # Greedy run of non-space/letter/number, exactly like the
            # regex: alternatives (specials, contractions) are only tried
            # at scan positions, never inside this greedy run — so
            # "!!<|eot|>" tokenizes as ["!!<|", "eot", "|>"], not the
            # special (matching re.findall semantics).
            j = i + 1
            while j < n and not (
                text[j].isspace() or _is_letter(text[j]) or _is_number(text[j])
            ):
                j += 1
        out.append(text[i:j])
        i = j
    return out


@functools.lru_cache()
def _bytes_to_unicode():
    """GPT-2-style byte <-> printable-unicode mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _clean(text: str) -> str:
    """basic_clean + whitespace_clean + lower, as the vendored
    ``clip.tokenize`` does; ftfy mojibake repair applied when the
    library is present (optional dep, zero-egress environments run
    without it)."""
    try:
        import ftfy

        text = ftfy.fix_text(text)
    except ImportError:
        pass
    text = html.unescape(html.unescape(text))
    return re.sub(r"\s+", " ", text.strip()).lower()


class CLIPTokenizer:
    """BPE tokenizer over the standard CLIP merges file."""

    def __init__(self, bpe_path: str, context_length: int = CONTEXT_LENGTH):
        self.context_length = context_length
        self.byte_encoder = _bytes_to_unicode()
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges[1 : 49152 - 256 - 2 + 1]]
        vocab = list(_bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self._cache: dict[str, list[str]] = {}

    def _bpe(self, token: str) -> list[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return [token + "</w>"]
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = list(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        ids = []
        for tok in split_words(_clean(text)):
            if tok in _SPECIALS:
                ids.append(self.encoder[tok])
                continue
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok))
        return ids

    def __call__(self, texts: list[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.context_length), np.int32)
        for i, text in enumerate(texts):
            ids = [SOT] + self.encode(text)[: self.context_length - 2] + [EOT]
            out[i, : len(ids)] = ids
        return out


class FallbackTokenizer:
    """Deterministic stand-in when no BPE vocab file is available:
    hash words into the vocab range with SOT/EOT framing. SOT/EOT are
    placed at the top of the configured vocab (so tiny test configs with
    small vocabularies stay in range)."""

    def __init__(self, context_length: int = CONTEXT_LENGTH, vocab_size: int = VOCAB_SIZE):
        self.context_length = context_length
        self.vocab_size = vocab_size
        self.sot = vocab_size - 2
        self.eot = vocab_size - 1

    def _id(self, token: str) -> int:
        h = hashlib.blake2b(token.encode("utf-8"), digest_size=4).digest()
        return 1 + int.from_bytes(h, "little") % (self.sot - 1)

    def __call__(self, texts: list[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.context_length), np.int32)
        for i, text in enumerate(texts):
            toks = split_words(_clean(text))[: self.context_length - 2]
            ids = [self.sot] + [self._id(t) for t in toks] + [self.eot]
            out[i, : len(ids)] = ids
        return out


def open_tokenizer(
    bpe_path: str | None,
    context_length: int = CONTEXT_LENGTH,
    vocab_size: int = VOCAB_SIZE,
):
    if bpe_path:
        return CLIPTokenizer(bpe_path, context_length)
    return FallbackTokenizer(context_length, vocab_size)
