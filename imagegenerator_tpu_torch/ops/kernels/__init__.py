"""Hand-written Hopper kernels, each beside its plain PyTorch version.

* ``attention`` — fused multi-head attention forward, CUDA C++
  (``csrc/attention_fwd.cu``), built by ``_build`` with ``nvcc``.
* ``layernorm`` — row LayerNorm forward, Triton.

A wrapper launches its kernel for a CUDA tensor and runs the plain
version for a CPU tensor; each counts its launches in ``launches``.
"""
