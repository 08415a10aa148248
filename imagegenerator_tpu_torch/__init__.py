"""imagegenerator_tpu_torch — the PyTorch/CUDA port of ``imagegenerator_tpu``.

The JAX package beside it is the reference: this package mirrors its
module layout (``ops/``, ``models/``, ``train/``, ``data/``,
``checkpoint/``, ``utils/``, ``v2/``) and is held to it by the parity
tests under ``tests/test_torch_*.py``. On an NVIDIA Hopper card it trains
stage 1 (64 px) and stage 2 (256 px) through ``train.cli``, samples
through ``train.sample`` (caption tokens -> BERT -> projection -> CA1 ->
G1 -> CA2 -> G2) and runs v2 VQGAN+CLIP generation, with BERT's attention
and LayerNorm, the codebook argmin and the scanline lerp in hand-written
kernels (``ops/kernels/``). It imports PyTorch and never JAX.
"""

__version__ = "0.1.0"
