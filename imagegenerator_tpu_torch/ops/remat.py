"""Rematerialisation: the counterpart of ``jax.checkpoint`` at the JAX
package's ``remat`` sites.

``remat(fn, *args)`` runs ``fn`` without keeping its activations for the
backward and runs it again when the backward needs them
(``torch.utils.checkpoint.checkpoint`` without reentrance, which
``torch.autograd.grad`` and a double backward go through). Two things
differ from JAX, where a recomputation is a pure function of its inputs:

* a BatchNorm layer writes its running statistics in its forward; the
  recomputation runs under ``ops/layers.py::statistics_frozen``, so the
  momentum is applied once;
* ``checkpoint`` replays the default generators' states only. A
  function that draws from an explicit generator (BERT's dropout masks,
  the fused attention's seeds) would draw anew: the caller draws every
  random input before and passes it in (``BertEncoder.draw``).
"""

from __future__ import annotations

import contextlib

from torch.utils.checkpoint import checkpoint

from imagegenerator_tpu_torch.ops.layers import statistics_frozen


def remat(fn, *args):
    """``fn(*args)``, recomputed in the backward instead of stored."""
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), statistics_frozen()))
