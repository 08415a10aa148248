"""Data parallelism over ``torch.distributed``: one process per card."""

from imagegenerator_tpu_torch.parallel import dp

__all__ = ["dp"]
