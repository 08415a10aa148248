"""Prefetching device loader: host threads -> collated numpy -> batches
of tensors on the device — counterpart of
``imagegenerator_tpu/data/pipeline.py``.

* worker threads pull sample indices, fetch + decode + resize images, and
  fill per-batch slots (disk reads and the resize release the GIL);
* batch threads tokenize the captions and assemble fixed-shape numpy
  batches, ``host_prefetch`` whole batches building at once;
* the consumer-facing iterator copies each batch into pinned host memory
  and on to the device with ``non_blocking=True``, ``device_prefetch``
  batches ahead of compute. uint8 images stay uint8 across the link.

The epoch's order is ``np.random.default_rng((seed, epoch)).permutation``,
as in the JAX package: the same ``(seed, epoch)`` serves the same
captions in the same order. Under data parallelism every rank shuffles
its own slice of the manifest with the same generator, and ``batch_size``
is per rank; on a tensor-parallel grid the slice is the data index's
(the dataset's ``host_index`` / ``host_count``, which ``train.cli`` sets
from ``parallel/mesh.py``), so the ranks of a model group read the same
rows. The ranks must take as many steps as each other, or a
collective would wait for ever, so each epoch starts by checking that
they do (``parallel/dp.py::check_same_on_all_ranks``).
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from imagegenerator_tpu_torch.parallel import dp
from imagegenerator_tpu_torch.utils.device import entry_device


class DataLoader:
    def __init__(
        self,
        dataset,
        tokenizer,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        num_workers: int = 8,
        host_prefetch: int = 8,
        device_prefetch: int = 2,
        device=None,
    ):
        if not drop_last:
            raise NotImplementedError("batches have one fixed shape: drop_last must be True")
        self.dataset = dataset
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.host_prefetch = host_prefetch
        self.device_prefetch = device_prefetch
        self.device = entry_device(device)  # the card unless the caller names another
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            return rng.permutation(n)
        return np.arange(n)

    def _host_batches(self):
        """Yield collated numpy batches with ``host_prefetch`` whole
        batches building concurrently. Two pools: ``sample_pool`` does the
        work (fetch, decode, resize), ``batch_pool`` threads only
        orchestrate and collate, so a batch waiting on its samples can
        never deadlock the samples' own workers."""
        indices = self._epoch_indices()
        nb = len(self)
        sample_pool = ThreadPoolExecutor(max_workers=self.num_workers)
        batch_pool = ThreadPoolExecutor(max_workers=max(2, min(self.host_prefetch, 8)))

        def build_batch(b: int):
            rows = indices[b * self.batch_size : (b + 1) * self.batch_size]
            futures = [sample_pool.submit(self.dataset.__getitem__, i) for i in rows]
            samples = [f.result() for f in futures]
            batch = dict(self.tokenizer([s[0] for s in samples]))
            batch["image"] = np.stack([s[1] for s in samples])
            return batch

        window: deque = deque()
        next_b = 0
        try:
            while next_b < min(self.host_prefetch, nb):
                window.append(batch_pool.submit(build_batch, next_b))
                next_b += 1
            while window:
                batch = window.popleft().result()
                if next_b < nb:
                    window.append(batch_pool.submit(build_batch, next_b))
                    next_b += 1
                yield batch
        finally:
            batch_pool.shutdown(wait=False, cancel_futures=True)
            sample_pool.shutdown(wait=False, cancel_futures=True)

    def _to_device(self, host_batch) -> dict:
        """Tensors on ``self.device``, dtypes kept. For the card each
        array (or CPU tensor, as a collate of a dtype numpy lacks gives)
        goes through pinned memory and an asynchronous copy, which the
        stream orders before the step that reads it."""
        out = {}
        for k, v in host_batch.items():
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def __iter__(self):
        """Batches on the device, ``device_prefetch`` ahead."""
        self.epoch += 1
        dp.check_same_on_all_ranks(len(self), "batches per epoch")
        pending: deque = deque()
        for host_batch in self._host_batches():
            pending.append(self._to_device(host_batch))
            if len(pending) > self.device_prefetch:
                yield pending.popleft()
        yield from pending
