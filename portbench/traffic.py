"""The one generator of training traffic: batches of captions and images
made on the device from the run's seed and a mix's data file
(``traffic/<mix>.json``).

A mix file gives:

* ``batch_per_rank``, ``ranks``: the rows one process steps on, and the
  processes (one per card) that step together;
* ``pool_batches``: how many distinct batches are made at set-up; step
  ``k`` feeds batch ``k % pool_batches`` (as a loader hands over resident
  batches), so the first ``pool_batches`` steps see rows that all differ;
* ``captions``: ``length_histogram`` (``[[tokens, weight], ...]``, the
  length of a caption with its ``[CLS]`` and ``[SEP]``), ``pad_to``
  (``"seq_len"``: the configuration's), ``cls_id``, ``sep_id``,
  ``pad_id``, ``first_word_id``: word ids are uniform in
  ``[first_word_id, vocab)``;
* ``images``: ``dtype`` (``uint8``: values uniform in [0, 255]) at the
  configuration's resolution, NHWC.

Every seed gets the same set of caption lengths in each batch, the
histogram's quantiles at ``(j + 0.5) / rows``, in an order drawn from the
seed: the seed changes which rows are long, never how much work a batch
holds.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.common import mix

BATCH_STREAM = 2


def quantile_lengths(histogram, rows: int) -> np.ndarray:
    """``rows`` lengths at the histogram's quantiles ``(j + 0.5) / rows``."""
    lengths = np.array([h[0] for h in histogram], np.int64)
    weights = np.array([h[1] for h in histogram], np.float64)
    cdf = np.cumsum(weights) / weights.sum()
    q = (np.arange(rows) + 0.5) / rows
    return lengths[np.minimum(np.searchsorted(cdf, q), len(lengths) - 1)]


def mean_length(histogram) -> float:
    w = sum(h[1] for h in histogram)
    return sum(h[0] * h[1] for h in histogram) / w


def captions(mix_spec: dict, rows: int, seq_len: int, vocab: int, seed: int, device):
    """``(input_ids, attention_mask)`` int32 ``(rows, seq_len)``."""
    c = mix_spec["captions"]
    lengths = quantile_lengths(c["length_histogram"], rows)
    if lengths.max() > seq_len:
        raise ValueError(f"caption of {lengths.max()} tokens past seq_len {seq_len}")
    host = torch.Generator().manual_seed(seed)
    lengths = torch.from_numpy(lengths)[torch.randperm(rows, generator=host)]
    g = torch.Generator(device=device).manual_seed(seed)
    ids = torch.randint(c["first_word_id"], vocab, (rows, seq_len), generator=g, device=device,
                        dtype=torch.int32)
    pos = torch.arange(seq_len, device=device)[None, :]
    lengths = lengths.to(device)[:, None]
    ids = torch.where(pos == lengths - 1, c["sep_id"], ids)
    ids[:, 0] = c["cls_id"]
    ids = torch.where(pos < lengths, ids, c["pad_id"]).to(torch.int32)
    mask = (pos < lengths).to(torch.int32)
    return ids, mask


def images(mix_spec: dict, rows: int, resolution: int, seed: int, device):
    if mix_spec["images"]["dtype"] != "uint8":
        raise ValueError(f"image dtype {mix_spec['images']['dtype']}: the generator makes uint8")
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, (rows, resolution, resolution, 3), generator=g, device=device,
                         dtype=torch.uint8)


def batch(mix_spec: dict, seed: int, rank: int, k: int, seq_len: int, vocab: int, resolution: int,
          device) -> dict:
    """Batch ``k`` of rank ``rank``: ``input_ids``, ``attention_mask``,
    ``image``."""
    rows = mix_spec["batch_per_rank"]
    s = mix(seed, BATCH_STREAM, rank, k)
    ids, mask = captions(mix_spec, rows, seq_len, vocab, s, device)
    return {"input_ids": ids, "attention_mask": mask,
            "image": images(mix_spec, rows, resolution, mix(s, 1), device)}


def pool(mix_spec: dict, seed: int, rank: int, seq_len: int, vocab: int, resolution: int, device) -> list:
    return [batch(mix_spec, seed, rank, k, seq_len, vocab, resolution, device)
            for k in range(mix_spec["pool_batches"])]
