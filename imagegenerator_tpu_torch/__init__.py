"""imagegenerator_tpu_torch — the PyTorch/CUDA port of ``imagegenerator_tpu``.

The JAX package beside it is the reference: this package mirrors its
module layout (``ops/``, ``models/``, ``train/``, ``data/``, ``utils/``)
and is held to it by the parity tests under ``tests/test_torch_*.py``.
It runs the v1 sampling path, caption tokens -> BERT -> projection ->
CA1 -> G1 (64 px) -> CA2 -> G2 (256 px), on an NVIDIA Hopper card, with
BERT's attention and LayerNorm forward in hand-written kernels
(``ops/kernels/``). It imports PyTorch and never JAX.
"""

__version__ = "0.1.0"
