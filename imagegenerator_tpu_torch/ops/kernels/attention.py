"""Fused multi-head self-attention forward over packed heads.

Replaces ``imagegenerator_tpu/ops/pallas/attention.py::_pallas_fwd``
(kernel ``_fwd_kernel``), which BERT reaches through ``fused_attention``
when ``BertConfig.fused_attention`` is set. On a CUDA tensor the wrapper
launches the hand-written kernel in ``csrc/attention_fwd.cu`` (CUDA C++
for ``sm_90a``, built by ``_build``); on a CPU tensor it runs
``attention_reference``, the plain PyTorch version of the same function.

What bounds it on the card: at BERT's shapes (batch 8, T = 128) neither
device memory nor the 0.4 GFLOP of products. The plain version spends
its time in a dozen small kernels (casts, two matmuls, mask, softmax,
divide) and, on the host, in launching them. The kernel does the whole
forward in one launch and keeps each head's scores in shared memory (one
block per batch row, head and 64-query tile), touching device memory
only for q, k, v, o, m and l. Its products run on the FMA units with one
shared-memory load per FMA, which bounds this first version; tensor
cores are the next step (PERF.md).

Numerics follow the TPU kernel: f32 products and sums, masked logits
filled with -3e7 (so a fully masked row is uniform), ``(m, l)`` kept
apart rather than as a log-sum-exp, probabilities rounded to v's dtype
before ``p V``, and ``1 / l`` folded into the context.

Dropout is not here: sampling runs attention at rate 0, and a non-zero
rate raises ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from imagegenerator_tpu_torch.ops.kernels import _build

BIG_NEG = -3e7
HEAD_DIM = 64
MAX_SEQ = 512
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches so far; the wrapper adds one per launch and nothing else
# does. Set it to 0 to count a run.
launches = 0


def supported(seq_len: int, hidden: int, num_heads: int) -> bool:
    """Shapes the JAX package's fused path takes; off them BERT runs its
    einsum attention. The port applies this rule only to CPU tensors, to
    stay with the JAX encoder. On the card ``fused_attention`` always goes
    to the kernel, which takes head dim 64 and any 0 < T <= 512 and
    raises otherwise."""
    hd = hidden // num_heads
    return hidden % num_heads == 0 and seq_len % 8 == 0 and hd % 8 == 0 and hd >= 8


def attention_reference(q, k, v, mask, num_heads: int):
    """Plain PyTorch version. q/k/v ``(B, T, H)``; mask ``(B, T)`` int
    (1 = keep) or None. Returns ``o (B, T, H)`` in q's dtype and
    ``m, l (B, heads, T)`` f32."""
    B, T, H = q.shape
    hd = H // num_heads
    qh = q.reshape(B, T, num_heads, hd).float()
    kh = k.reshape(B, T, num_heads, hd).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * (1.0 / math.sqrt(hd))
    if mask is not None:
        s = torch.where(mask[:, None, None, :] > 0, s, BIG_NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    vh = v.reshape(B, T, num_heads, hd).float()
    ctx = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vh)
    o = ctx / l.permute(0, 2, 1, 3)
    return o.reshape(B, T, H).to(q.dtype), m[..., 0], l[..., 0]


@functools.cache
def _entry():
    fn = _build.library().attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda(q, k, v, mask, num_heads):
    B, T, H = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"attention: {name} is {tuple(t.shape)} {t.dtype} on "
                f"{t.device}, q is {tuple(q.shape)} {q.dtype} on {q.device}"
            )
    if q.dtype not in _DTYPES:
        raise TypeError(f"attention: dtype {q.dtype} (kernel takes f32, bf16)")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("attention: q, k and v must be contiguous")
    if H % num_heads or H // num_heads != HEAD_DIM:
        raise ValueError(
            f"attention: hidden {H} / {num_heads} heads; kernel takes "
            f"head dim {HEAD_DIM}"
        )
    if not 0 < T <= MAX_SEQ or B > 65535 or B * T * H >= 2**31:
        raise ValueError(
            f"attention: B={B}, T={T}; kernel takes 0 < T <= {MAX_SEQ}, "
            f"B <= 65535"
        )
    if mask is not None and (
        mask.shape != (B, T) or mask.dtype != torch.int32
        or mask.device != q.device or not mask.is_contiguous()
    ):
        raise ValueError(
            f"attention: mask must be contiguous int32 (B, T) on {q.device}"
        )


def attention_fwd(q, k, v, mask, num_heads: int):
    """``(o, m, l)`` of the forward, the outputs of ``_pallas_fwd``:
    the kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, mask, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"attention: no kernel for device {q.device}")
    _check_cuda(q, k, v, mask, num_heads)
    global launches
    B, T, H = q.shape
    o = torch.empty_like(q)
    m = torch.empty((B, num_heads, T), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    with torch.cuda.device(q.device):
        rc = _entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(),
            o.data_ptr(), m.data_ptr(), l.data_ptr(),
            B, T, H, num_heads, _DTYPES[q.dtype], 1.0 / math.sqrt(HEAD_DIM),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, "attention_fwd")
    launches += 1
    return o, m, l


def fused_attention(q, k, v, mask, *, num_heads: int, dropout_rate: float = 0.0):
    """Multi-head attention over packed heads: q/k/v ``(B, T, H)`` raw
    Dense outputs, mask ``(B, T)`` (1 = keep) or None. Returns the
    ``(B, T, H)`` context in q's dtype."""
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "fused_attention: dropout is not ported yet (sampling runs "
            "attention at rate 0)"
        )
    if mask is not None:
        mask = mask.to(torch.int32).contiguous()
    return attention_fwd(q, k, v, mask, num_heads)[0]
