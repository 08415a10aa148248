"""Metrics: console + TensorBoard scalar and image-grid logging — the
port's own copy of ``imagegenerator_tpu/utils/metrics.py`` (numpy only;
TensorBoard is optional).

A train step returns its metrics as 0-d tensors on the device; the
trainer reads them (one host sync) only at the configured log interval
and hands this writer floats. Under data parallelism only rank 0 writes
(``parallel/dp.py``): the metrics are averaged over the ranks already.
"""

from __future__ import annotations

import numpy as np

from imagegenerator_tpu_torch.parallel import dp


def image_grid(images: np.ndarray, nrow: int = 8, pad: int = 2) -> np.ndarray:
    """(N, H, W, C) in [-1, 1] or [0, 1] -> one (H', W', C) grid in [0, 1]
    (the torchvision.make_grid role, normalize=True semantics)."""
    images = np.asarray(images, np.float32)
    lo, hi = images.min(), images.max()
    images = (images - lo) / max(hi - lo, 1e-8)
    n, h, w, c = images.shape
    ncol = min(nrow, n)
    nr = (n + ncol - 1) // ncol
    grid = np.ones((nr * (h + pad) + pad, ncol * (w + pad) + pad, c), np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        y0 = pad + r * (h + pad)
        x0 = pad + col * (w + pad)
        grid[y0 : y0 + h, x0 : x0 + w] = images[i]
    return grid


def _open_tb_writer(logdir: str):
    """Best available TensorBoard writer: tensorboardX (what the
    ``tensorboard`` extra installs), then torch.utils.tensorboard (same
    API, needs the ``tensorboard`` package). With neither, a warning and
    None: scalars still go to stdout, image grids are dropped."""
    try:
        from tensorboardX import SummaryWriter

        return SummaryWriter(logdir)
    except ImportError:
        pass
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(logdir)
    except ImportError:
        pass
    import warnings

    warnings.warn(
        "TensorBoard logging requested but neither tensorboardX nor "
        "torch.utils.tensorboard is importable — scalars will only go to "
        "stdout and image grids will be DROPPED. Install the 'tensorboard' "
        "extra (pip install imagegenerator-tpu[tensorboard]).",
        stacklevel=3,
    )
    return None


class MetricsWriter:
    def __init__(self, logdir: str | None = None, use_tensorboard: bool = True):
        self._tb = None
        self._main = dp.is_main()
        if logdir and use_tensorboard and self._main:
            self._tb = _open_tb_writer(logdir)

    def scalars(self, step: int, values: dict) -> None:
        if not self._main:
            return
        parts = ", ".join(f"{k}: {float(v):.4f}" for k, v in values.items())
        print(f"step {step}: {parts}", flush=True)
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(k, float(v), global_step=step)

    def images(self, step: int, tag: str, images: np.ndarray) -> None:
        if self._tb is not None:
            grid = image_grid(np.asarray(images))
            self._tb.add_image(tag, grid, global_step=step, dataformats="HWC")

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
