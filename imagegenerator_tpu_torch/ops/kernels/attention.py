"""Fused multi-head self-attention over packed heads, forward and
backward, with attention-prob dropout.

Replaces ``imagegenerator_tpu/ops/pallas/attention.py``: ``_pallas_fwd``
(kernel ``_fwd_kernel``) and ``_pallas_bwd`` (kernel ``_bwd_kernel``),
which BERT reaches through ``fused_attention`` when
``BertConfig.fused_attention`` is set. On a CUDA tensor the wrappers
launch the hand-written kernels in ``csrc/attention_fwd.cu`` and
``csrc/attention_bwd.cu`` (CUDA C++ for ``sm_90a``, built by ``_build``;
their tensor-core pieces are in ``csrc/attention_mma.cuh``);
on a CPU tensor they run ``attention_reference`` and
``attention_bwd_reference``, the plain PyTorch versions of the same
functions. ``fused_attention`` is a ``torch.autograd.Function`` whose
forward saves what the TPU custom VJP saves (q, k, v, mask, m, l).

They take every shape the JAX fused path takes (``supported``: head dim
d a multiple of 8, at least 8) at any T >= 1, not only T % 8 == 0
(``takes``). What bounds them on the card: bytes at BERT's T = 128,
operations from T of a few hundred, where the work per head grows as
T^2. The plain versions write and reread the (B, heads, T, T) scores and
probabilities between a dozen small kernels each way; the kernels keep
them on the SM.

Two routes, one rule on dtype and head dim (``kernel_route``): bf16
inputs with d <= 256 take the tensor cores (``mma.sync`` m16n8k16 on bf16
tiles in shared memory, scores and probabilities in registers), at any
T: a kernel that keeps a whole head in shared memory where d = 64 and
T <= 128 (the backward one launch with each of its five products once),
else kernels that walk the keys (and in the backward's second launch the
queries) in tiles, two passes so that p is formed against the final row
max as on the TPU. f32 inputs, where tensor cores would mean TF32, and
bf16 with d > 256 take the FMA kernels (64 x 64 f32 pieces in shared
memory, the same two passes, any d and T). Each backward but the
whole-head one is two launches with the row term D through a device
buffer. It is no fallback: on a CUDA tensor the wrapper launches the
kernel the rule names or raises, and it raises only for shapes outside
the JAX domain or past the grid's and int32's limits.

Numerics follow the TPU kernels on every route: the scale is
``1 / sqrt(d)`` of the actual head dim, products and sums in f32 (of
exact bf16 products on the tensor cores), masked logits filled with -3e7
(so a fully masked row is uniform), ``(m, l)`` kept apart rather than as
a log-sum-exp so the backward recomputes the probabilities with no
reductions, l summed from p before dropout, probabilities rounded to v's
dtype before ``p V``, the context divided by l; in the backward ``pd``
rounded to do's dtype before ``dv``, ``ds`` zero on masked key columns
and rounded to q's dtype before ``dq`` and ``dk``, ``dq`` summed in a
fixed order (no atomics). One departure, in the tiled tensor-core
kernels: p is ``2^(s scale log2 e - m log2 e)`` by one FMA and the
``ex2`` unit, within about 1e-6 relative of ``exp(scale s - m)`` for
scaled scores in the tens; their forward and backward form it alike.

Dropout: the keep-mask is the JAX package's interpret-mode counter hash
(``_hash_bits``, ``_keep_mask``), addressed by (seed, batch row, head,
query, key), so forward, backward and the plain versions draw the same
bits and no mask is stored. See ``keep_mask``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from imagegenerator_tpu_torch.ops.kernels import _build

BIG_NEG = -3e7
MMA_MAX_HEAD_DIM = 256  # bf16 head dims past this take the FMA kernels
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MASK32 = 0xFFFFFFFF

# Kernel launches so far; the wrappers add one per launch and nothing
# else does. ``launches`` counts forward launches at any rate,
# ``dropout_launches`` those of them with dropout on, ``bwd_launches``
# backward launches, both over the two routes; ``mma_launches`` and
# ``mma_bwd_launches`` count those of them that went to the tensor-core
# kernels. Set them to 0 to count a run.
launches = 0
dropout_launches = 0
bwd_launches = 0
mma_launches = 0
mma_bwd_launches = 0
# The model FLOPs of those launches (``fwd_flops``, ``bwd_flops``), which
# ``torch.utils.flop_counter.FlopCounterMode`` cannot see in a kernel
# launched through ``ctypes``; the bench adds them to its count.
flops = 0


def fwd_flops(batch: int, seq: int, hidden: int) -> int:
    """The two products of the forward, ``QK^T`` and ``PV``: 2 x 2 B T^2
    H over all heads (H = heads x head_dim), what FlopCounterMode counts
    for the plain version."""
    return 4 * batch * seq * seq * hidden


def bwd_flops(batch: int, seq: int, hidden: int) -> int:
    """The four products of the plain backward (dP, dV, dQ, dK); the
    kernels' recomputed scores are not model work."""
    return 8 * batch * seq * seq * hidden


def takes(hidden: int, num_heads: int) -> bool:
    """Whether the kernels take this width and head count: a head dim
    that is a multiple of 8 and at least 8, at any T >= 1."""
    hd = hidden // num_heads
    return hidden % num_heads == 0 and hd % 8 == 0 and hd >= 8


def supported(seq_len: int, hidden: int, num_heads: int) -> bool:
    """Shapes the JAX package's fused path takes (``takes`` and
    T % 8 == 0); off them BERT runs its einsum attention. BERT applies
    this rule to CPU tensors, to stay with the JAX encoder; on the card it
    sends every shape the kernels take (``takes``, any T) to them."""
    return seq_len % 8 == 0 and takes(hidden, num_heads)


# ---------------------------------------------------------------- dropout


def threshold(rate: float) -> int:
    """Keep iff ``bits >= threshold(rate)``, as ``_keep_mask`` sets it."""
    return min(int(rate * 4294967296.0), 4294967295)


def _mul32(x, c: int):
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32), in two 16-bit
    halves of ``c`` so no product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _finalize(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def keep_mask(batch: int, num_heads: int, seq: int, seed: int, rate: float, device=None):
    """The dropout keep-mask ``(B, heads, T, T)`` bool, [row, head, query,
    key]: the uint32 counter hash of ``attention_common.cuh`` computed in
    int64, masked to 32 bits after every multiply and add."""
    dev = dict(dtype=torch.int64, device=device)
    b = torch.arange(batch, **dev)[:, None]
    h = torch.arange(num_heads, **dev)[None, :]
    salt = (seed + b * 1000003 + h * 7919) & _MASK32  # wrapping int32 -> uint32
    r = torch.arange(seq, **dev)[:, None]
    c = torch.arange(seq, **dev)[None, :]
    rc = (_mul32(r, 0x9E3779B9) + _mul32(c, 0x85EBCA6B)) & _MASK32
    x = (rc + _mul32(salt, 0xC2B2AE35)[:, :, None, None]) & _MASK32
    return _finalize(x) >= threshold(rate)


def _keep_scale(q, num_heads, rate, seed):
    """``keep * 1 / (1 - rate)`` as f32, or None at rate 0."""
    if rate <= 0.0:
        return None
    B, T, _ = q.shape
    keep = keep_mask(B, num_heads, T, seed, rate, q.device)
    return keep.float() * (1.0 / (1.0 - rate))


def _dropout_args(rate: float, seed: int):
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"attention: dropout rate {rate} (need 0 <= rate < 1)")
    if rate == 0.0:
        return 0, 0, 0, 1.0
    seed = ((int(seed) + 2**31) % 2**32) - 2**31  # as int32
    return 1, seed, threshold(rate), 1.0 / (1.0 - rate)


# ---------------------------------------------------------- plain versions


def _heads(t, num_heads):
    B, T, H = t.shape
    return t.reshape(B, T, num_heads, H // num_heads).float()


def _scores(q, k, mask, num_heads):
    hd = q.shape[2] // num_heads
    s = torch.einsum("bqhd,bkhd->bhqk", _heads(q, num_heads), _heads(k, num_heads))
    s = s * (1.0 / math.sqrt(hd))
    if mask is not None:
        s = torch.where(mask[:, None, None, :] > 0, s, BIG_NEG)
    return s


def attention_reference(q, k, v, mask, num_heads: int, rate: float = 0.0, seed: int = 0):
    """Plain PyTorch forward. q/k/v ``(B, T, H)``; mask ``(B, T)`` int
    (1 = keep) or None. Returns ``o (B, T, H)`` in q's dtype and
    ``m, l (B, heads, T)`` f32."""
    B, T, H = q.shape
    s = _scores(q, k, mask, num_heads)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    keep = _keep_scale(q, num_heads, rate, seed)
    if keep is not None:
        p = p * keep
    ctx = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), _heads(v, num_heads))
    o = ctx / l.permute(0, 2, 1, 3)
    return o.reshape(B, T, H).to(q.dtype), m[..., 0], l[..., 0]


def attention_bwd_reference(q, k, v, do, mask, m, l, num_heads: int, rate: float = 0.0,
                            seed: int = 0):
    """Plain PyTorch backward, ``_bwd_kernel``'s math: ``(dq, dk, dv)`` in
    q's dtype from q/k/v/do ``(B, T, H)`` (do in q's dtype), mask, and the
    forward's ``m, l (B, heads, T)``."""
    B, T, H = q.shape
    scale = 1.0 / math.sqrt(H // num_heads)
    probs = torch.exp(_scores(q, k, mask, num_heads) - m[..., None]) * (1.0 / l)[..., None]
    keep = _keep_scale(q, num_heads, rate, seed)
    pd = probs if keep is None else probs * keep
    do_h = _heads(do, num_heads)
    dv = torch.einsum("bhqk,bqhd->bkhd", pd.to(do.dtype).float(), do_h)
    dp = torch.einsum("bqhd,bkhd->bhqk", do_h, _heads(v, num_heads))
    if keep is not None:
        dp = dp * keep
    ds = probs * (dp - (dp * probs).sum(dim=-1, keepdim=True))
    if mask is not None:
        ds = torch.where(mask[:, None, None, :] > 0, ds, 0.0)
    ds = (ds * scale).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, _heads(k, num_heads))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, _heads(q, num_heads))
    return tuple(t.reshape(B, T, H).to(q.dtype) for t in (dq, dk, dv))


# ------------------------------------------------------------------ kernels


def kernel_route(dtype, head_dim: int) -> str:
    """Which kernels a CUDA tensor of ``dtype`` and head dim ``head_dim``
    takes, at any T: ``"mma"`` (tensor cores) for bf16 with d <= 256,
    else ``"fma"``. Within the tensor-core route the C entry point takes
    the whole-head kernels at d = 64 and T <= 128 and the tiled ones
    elsewhere."""
    return "mma" if dtype == torch.bfloat16 and head_dim <= MMA_MAX_HEAD_DIM else "fma"


def _route(q, num_heads: int) -> str:
    return kernel_route(q.dtype, q.shape[2] // num_heads)


@functools.cache
def _entry(name):
    fn = getattr(_build.library(name), name)
    n_ptr = 7 if name == "attention_fwd" else 11
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_uint32, ctypes.c_float,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda(q, others, mask, num_heads):
    B, T, H = q.shape
    for name, t in others:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"attention: {name} is {tuple(t.shape)} {t.dtype} on "
                f"{t.device}, q is {tuple(q.shape)} {q.dtype} on {q.device}"
            )
    if q.dtype not in _DTYPES:
        raise TypeError(f"attention: dtype {q.dtype} (kernel takes f32, bf16)")
    if not q.is_contiguous() or not all(t.is_contiguous() for _, t in others):
        raise ValueError("attention: q, k, v (and do) must be contiguous")
    if num_heads < 1 or not takes(H, num_heads):
        raise ValueError(
            f"attention: hidden {H} / {num_heads} heads; the kernels take a "
            "head dim that is a multiple of 8 and at least 8"
        )
    if T < 1 or B > 65535 or num_heads > 65535 or B * T * H >= 2**31:
        raise ValueError(
            f"attention: B={B}, T={T}, H={H}, {num_heads} heads; the kernels "
            "take T >= 1, B and heads <= 65535, B * T * H < 2**31"
        )
    if mask is not None and (
        mask.shape != (B, T) or mask.dtype != torch.int32
        or mask.device != q.device or not mask.is_contiguous()
    ):
        raise ValueError(
            f"attention: mask must be contiguous int32 (B, T) on {q.device}"
        )


def _check_stats(q, m, l, num_heads):
    B, T, _ = q.shape
    for name, t in (("m", m), ("l", l)):
        if (t.shape != (B, num_heads, T) or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(
                f"attention: {name} must be contiguous f32 ({B}, {num_heads}, {T})"
            )


def _device(q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention: no kernel for device {q.device}")
    return q.device.type


def _launch_fwd(q, k, v, mask, num_heads, drop, route):
    """Launch the forward kernel of ``route`` on checked CUDA tensors."""
    global launches, dropout_launches, mma_launches, flops
    mma = _route_arg(route, (q, k, v))
    B, T, H = q.shape
    o = torch.empty_like(q)
    m = torch.empty((B, num_heads, T), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    with torch.cuda.device(q.device):
        rc = _entry("attention_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(),
            o.data_ptr(), m.data_ptr(), l.data_ptr(),
            B, T, H, num_heads, _DTYPES[q.dtype], mma, _scale(H, num_heads), *drop,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, "attention_fwd")
    launches += 1
    dropout_launches += drop[0]
    mma_launches += mma
    flops += fwd_flops(B, T, H)
    return o, m, l


def _launch_bwd(q, k, v, do, mask, m, l, num_heads, drop, route):
    """Launch the backward kernel or kernels of ``route`` on checked CUDA
    tensors."""
    global bwd_launches, mma_bwd_launches, flops
    mma = _route_arg(route, (q, k, v, do))
    B, T, H = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    # the row term D, from a two-launch backward's first launch to its second
    d_row = torch.empty_like(m)
    with torch.cuda.device(q.device):
        rc = _entry("attention_bwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            None if mask is None else mask.data_ptr(),
            m.data_ptr(), l.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            d_row.data_ptr(),
            B, T, H, num_heads, _DTYPES[q.dtype], mma, _scale(H, num_heads), *drop,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, "attention_bwd")
    bwd_launches += 1
    mma_bwd_launches += mma
    flops += bwd_flops(B, T, H)
    return dq, dk, dv


def _scale(hidden: int, num_heads: int) -> float:
    """``1 / sqrt(d)`` of the actual head dim, as the JAX kernel takes it
    from ``H // num_heads``."""
    return 1.0 / math.sqrt(hidden // num_heads)


def _route_arg(route: str, tensors) -> int:
    """The C entry points' ``route`` argument: 1 for the tensor-core
    kernels, which copy 16 bytes a thread and so need aligned tensors."""
    if route != "mma":
        return 0
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("attention: the tensor-core kernels need q, k, v (and do) "
                         "16-byte aligned")
    return 1


def attention_fwd(q, k, v, mask, num_heads: int, rate: float = 0.0, seed: int = 0):
    """``(o, m, l)`` of the forward, the outputs of ``_pallas_fwd``: on a
    CUDA tensor the kernel ``kernel_route`` names, on a CPU tensor the
    plain version."""
    drop = _dropout_args(rate, seed)
    if _device(q) == "cpu":
        return attention_reference(q, k, v, mask, num_heads, rate, seed)
    _check_cuda(q, (("k", k), ("v", v)), mask, num_heads)
    return _launch_fwd(q, k, v, mask, num_heads, drop, _route(q, num_heads))


def attention_bwd(q, k, v, do, mask, m, l, num_heads: int, rate: float = 0.0, seed: int = 0):
    """``(dq, dk, dv)`` of the backward, the outputs of ``_pallas_bwd``,
    from the forward's inputs, ``do`` in q's dtype and its ``(m, l)``: on a
    CUDA tensor the kernel ``kernel_route`` names, on a CPU tensor the
    plain version."""
    drop = _dropout_args(rate, seed)
    if _device(q) == "cpu":
        return attention_bwd_reference(q, k, v, do, mask, m, l, num_heads, rate, seed)
    _check_cuda(q, (("k", k), ("v", v), ("do", do)), mask, num_heads)
    _check_stats(q, m, l, num_heads)
    return _launch_bwd(q, k, v, do, mask, m, l, num_heads, drop, _route(q, num_heads))


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, num_heads, rate, seed):
        o, m, l = attention_fwd(q, k, v, mask, num_heads, rate, seed)
        ctx.save_for_backward(q, k, v, mask, m, l)
        ctx.args = (num_heads, rate, seed)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, m, l = ctx.saved_tensors
        grads = attention_bwd(q, k, v, do.to(q.dtype).contiguous(), mask, m, l, *ctx.args)
        return (*grads, None, None, None, None)


def fused_attention(q, k, v, mask, *, num_heads: int, dropout_rate: float = 0.0,
                    seed: int = 0):
    """Multi-head attention over packed heads: q/k/v ``(B, T, H)`` raw
    Dense outputs, mask ``(B, T)`` (1 = keep) or None, attention-prob
    dropout at ``dropout_rate`` with the keep-mask of ``seed`` (an int32,
    ignored at rate 0). Returns the ``(B, T, H)`` context in q's dtype,
    differentiable in q, k and v."""
    if mask is not None:
        mask = mask.to(torch.int32).contiguous()
    return _FusedAttention.apply(q, k, v, mask, num_heads, float(dropout_rate), int(seed))
