"""Data parallelism over ``torch.distributed`` (one process per card) and
tensor parallelism over a data x model grid of ranks."""

from imagegenerator_tpu_torch.parallel import dp, mesh, tp

__all__ = ["dp", "mesh", "tp"]
