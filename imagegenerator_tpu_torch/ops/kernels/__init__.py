"""Hand-written Hopper kernels, each beside its plain PyTorch version.

* ``attention`` — fused multi-head attention forward (with
  attention-prob dropout) and backward, CUDA C++
  (``csrc/attention_fwd.cu``, ``csrc/attention_bwd.cu``), built by
  ``_build`` with ``nvcc``; ``fused_attention`` is their
  ``autograd.Function``.
* ``layernorm`` — row LayerNorm forward, CUDA C++
  (``csrc/layernorm_fwd.cu``), and backward, Triton;
  ``fused_layernorm`` is their ``autograd.Function``.
* ``vq_argmin`` — nearest-codebook search without the (N, K) distance
  matrix, CUDA C++ on the tensor cores in split TF32
  (``csrc/vq_argmin.cu``); no gradient.
* ``scanline_lerp`` — two-tap scanline resample forward, Triton;
  ``scanline_lerp`` is its ``autograd.Function``, whose backward is the
  dense transposed contraction in PyTorch ops, as in the JAX package.

A wrapper launches its kernel for a CUDA tensor and runs the plain
version for a CPU tensor; each counts its launches (``launches``,
``bwd_launches``, and for attention ``dropout_launches``).
"""
