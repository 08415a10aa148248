"""The port's hand-written kernels against their plain versions on a CUDA
card: the attention forward (CUDA C++) over sequence lengths, with and
without dropout (keep-rate read back); the attention backward (CUDA C++)
with and without mask and dropout, both on the route
``attention.kernel_route`` names (tensor cores for bf16 with a head dim up
to 256, FMA units otherwise; the counters say which ran); the pair over a
grid of head dims (8 to 320) and lengths (1 to 1024), masks and rates,
with the keep-mask's bits read back from both; the
LayerNorm forward (CUDA C++, both its routes) and backward (Triton) over
widths, row counts and dtypes; the ``autograd.Function``s against PyTorch's autograd through the
plain forwards; the wrappers' launch counts and refusals; the BERT
encoder with the kernels on against off, forward and backward; the
codebook argmin (CUDA C++, tensor cores) over row counts, codebook sizes
and widths off every tile size, with planted ties, calls in a row through
one scratch buffer and a call on a second stream; the scanline lerp (Triton) over
shapes, strided sources and coordinate kinds, and its
``autograd.Function``; and one v2 engine step with the two on against
off. Marked
``cuda``: skipped where there is no card. On a card, from the repository
root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest configures JAX, which the card's
machine need not have; these tests import only PyTorch and the port.)

Tolerances as in ``chip_smoke.py``: attention o rtol 1e-4 / atol 1e-5 in
f32 and 2e-2 / 2e-2 in bf16, m and l rtol 1e-4 (m with atol 1e-5 on the
tensor-core kernels, which add a score's products in another order; on
the grid m with atol 1e-5 on either route, whose sums over d run in
another order than the plain version's GEMM); keep bits equal;
attention gradients
rtol 1e-3 / atol 1e-4 in f32 and 2e-2 / 2e-2 in bf16; LayerNorm y rtol =
atol = 1e-5, mean and rstd rtol 1e-5, dx rtol = atol = 1e-4 (f32),
dgamma and dbeta rtol 1e-4 / atol 1e-3 (sums over the rows in another
order); the argmin's indices equal the plain version's, or, on random
inputs, name a code whose score is within 1e-5 of the row's score range
of the plain version's; the lerp 1e-6 abs, its backward 2e-2 (the bf16
rounding of weights and cotangent)."""

import dataclasses

import pytest
import torch

from imagegenerator_tpu_torch.models import bert
from imagegenerator_tpu_torch.ops import quantize
from imagegenerator_tpu_torch.ops.kernels import attention, layernorm, scanline_lerp, vq_argmin

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _mask(B, T):
    mask = torch.ones((B, T), dtype=torch.int32, device="cuda")
    for b in range(1, B):
        mask[b, T - (b * T) // (B + 1):] = 0
    mask[-1] = 0
    return mask


GRAD_TOL = {torch.float32: dict(rtol=1e-3, atol=1e-4), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
# m is a score: the tensor cores add its 64 exact bf16 products in another
# order than the plain version's f32 GEMM, about 1e-6 apart in absolute
# terms, and a row whose maximum is near 0 has no relative agreement
M_TOL = {torch.float32: dict(rtol=1e-4, atol=0), torch.bfloat16: dict(rtol=1e-4, atol=1e-5)}
OUT_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,with_mask", [(8, 128, True), (3, 40, True), (2, 8, True),
                                           (2, 256, False), (2, 512, True), (1, 72, False),
                                           (4, 77, True), (2, 1, False), (1, 16, True),
                                           (1, 100, False), (3, 127, True), (1, 128, True)])
def test_attention_kernel_matches_plain(gen, B, T, with_mask, dtype):
    H, nh = 768, 12
    q, k, v = (torch.randn((B, T, H), generator=gen, device="cuda").to(dtype) for _ in range(3))
    mask = _mask(B, T) if with_mask else None
    attention.launches = attention.mma_launches = 0
    got = attention.attention_fwd(q, k, v, mask, nh)
    torch.cuda.synchronize()
    assert attention.launches == 1
    assert attention.mma_launches == (dtype == torch.bfloat16)
    want = attention.attention_reference(q, k, v, mask, nh)
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(got[0].float(), want[0].float(), **tol)
    torch.testing.assert_close(got[1], want[1], **M_TOL[dtype])
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=0)


# shapes outside the JAX fused path's domain (head dims 32, 96 and T > 512
# were refused here until the kernels took every shape of that domain)
@pytest.mark.parametrize(
    "shape,nh,dtype,mask_dtype",
    [((2, 16, 80), 4, torch.float32, torch.int32),     # head dim 20
     ((2, 520, 16), 4, torch.bfloat16, torch.int32),   # head dim 4
     ((2, 0, 768), 12, torch.float32, torch.int32),    # T == 0
     ((2, 16, 768), 7, torch.float32, torch.int32),    # 768 not a multiple of 7 heads
     ((2, 16, 768), 12, torch.float16, torch.int32),   # dtype
     ((2, 16, 768), 12, torch.float32, torch.int64),   # mask dtype
     ((65536, 1, 8), 1, torch.bfloat16, torch.int32)],  # B past the grid's 65535
)
def test_attention_wrapper_refuses(gen, shape, nh, dtype, mask_dtype):
    q = torch.zeros(shape, dtype=dtype, device="cuda")
    mask = torch.ones(shape[:2], dtype=mask_dtype, device="cuda")
    attention.launches = 0
    with pytest.raises((ValueError, TypeError)):
        attention.attention_fwd(q, q, q, mask, nh)
    with pytest.raises(ValueError):
        attention.attention_fwd(q.transpose(0, 1), q, q, None, nh)
    with pytest.raises((ValueError, TypeError)):
        attention.attention_bwd(q, q, q, q, mask, q[:, :1], q[:, :1], nh)
    attention.bwd_launches = 0
    assert attention.launches == 0 and attention.bwd_launches == 0


def test_attention_wrappers_refuse_bad_rate_and_stats(gen):
    q = torch.zeros((2, 16, 768), device="cuda")
    stat = torch.zeros((2, 12, 16), device="cuda")
    attention.launches = attention.bwd_launches = 0
    with pytest.raises(ValueError, match="rate"):
        attention.attention_fwd(q, q, q, None, 12, 1.0, 0)
    with pytest.raises(ValueError, match="m must"):
        attention.attention_bwd(q, q, q, q, None, stat[:, :6], stat, 12)
    with pytest.raises(ValueError, match="l must"):
        attention.attention_bwd(q, q, q, q, None, stat, stat.double(), 12)
    with pytest.raises(ValueError):
        attention.attention_bwd(q, q, q, q.bfloat16(), None, stat, stat, 12)
    assert attention.launches == 0 and attention.bwd_launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_attention_dropout_forward_matches_plain(gen, rate, dtype):
    B, T, H, nh = 16, 128, 768, 12
    q, k, v = (torch.randn((B, T, H), generator=gen, device="cuda").to(dtype) for _ in range(3))
    mask = _mask(B, T)
    attention.launches = attention.dropout_launches = attention.mma_launches = 0
    o, m, l = attention.attention_fwd(q, k, v, mask, nh, rate, 1234)
    torch.cuda.synchronize()
    assert attention.launches == attention.dropout_launches == 1
    assert attention.mma_launches == (dtype == torch.bfloat16)
    ro, rm, rl = attention.attention_reference(q, k, v, mask, nh, rate, 1234)
    torch.testing.assert_close(o.float(), ro.float(), **OUT_TOL[dtype])
    torch.testing.assert_close(m, rm, **M_TOL[dtype])
    torch.testing.assert_close(l, rl, rtol=1e-4, atol=0)
    keep = attention.keep_mask(B, nh, T, 1234, rate, "cuda").float().mean().item()
    assert abs(keep - (1 - rate)) < 0.005
    # the same seed gives the same output; another seed another
    assert torch.equal(o, attention.attention_fwd(q, k, v, mask, nh, rate, 1234)[0])
    assert not torch.equal(o, attention.attention_fwd(q, k, v, mask, nh, rate, 1235)[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,T,with_mask", [(8, 128, True), (4, 128, False), (3, 77, True),
                                           (2, 1, False), (2, 512, True), (3, 40, True),
                                           (1, 16, True), (1, 100, False), (3, 127, True),
                                           (1, 128, False)])
def test_attention_backward_matches_plain(gen, B, T, with_mask, rate, dtype):
    H, nh = 768, 12
    q, k, v, do = (torch.randn((B, T, H), generator=gen, device="cuda").to(dtype) for _ in range(4))
    mask = _mask(B, T) if with_mask else None
    _, m, l = attention.attention_reference(q, k, v, mask, nh, rate, 99)
    attention.bwd_launches = attention.mma_bwd_launches = 0
    got = attention.attention_bwd(q, k, v, do, mask, m, l, nh, rate, 99)
    torch.cuda.synchronize()
    assert attention.bwd_launches == 1
    assert attention.mma_bwd_launches == (dtype == torch.bfloat16)
    want = attention.attention_bwd_reference(q, k, v, do, mask, m, l, nh, rate, 99)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype, name
        torch.testing.assert_close(g.float(), w.float(), msg=name, **GRAD_TOL[dtype])
    if with_mask:  # the fully masked last row gets no dq, dk
        assert not got[0][-1].any() and not got[1][-1].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_attention_function_against_autograd_of_plain(gen, rate, dtype):
    """The autograd.Function (kernels both ways) against PyTorch's own
    autograd through the plain forward, whose keep-mask is a constant.
    In bf16 the plain side runs on the same rounded inputs widened to f32
    (autograd through its own roundings of p and o would pass them
    straight, which is not what the kernel's backward computes)."""
    B, T, H, nh = 4, 96, 768, 12
    leaves = [torch.randn((B, T, H), generator=gen, device="cuda").to(dtype).requires_grad_(True)
              for _ in range(3)]
    mask = _mask(B, T)
    do = torch.randn((B, T, H), generator=gen, device="cuda").to(dtype)
    attention.launches = attention.bwd_launches = 0
    attention.mma_launches = attention.mma_bwd_launches = 0
    attention.fused_attention(*leaves, mask, num_heads=nh, dropout_rate=rate, seed=5).backward(do)
    assert (attention.launches, attention.bwd_launches) == (1, 1)
    on_tensor_cores = int(dtype == torch.bfloat16)
    assert (attention.mma_launches, attention.mma_bwd_launches) == (on_tensor_cores,) * 2
    got = [t.grad for t in leaves]
    plain = [t.detach().float().requires_grad_(True) for t in leaves]
    attention.attention_reference(*plain, mask, nh, rate, 5)[0].backward(do.float())
    for name, g, p in zip(("dq", "dk", "dv"), got, plain):
        assert g.dtype == dtype, name
        torch.testing.assert_close(g.float(), p.grad, msg=name, **GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [128, 77])
def test_attention_kernels_repeat_bit_for_bit(gen, T, dtype):
    """Neither route sums with atomics: two calls on the same inputs give
    equal bits, forward and backward, with dropout on."""
    B, H, nh = 6, 768, 12
    q, k, v, do = (torch.randn((B, T, H), generator=gen, device="cuda").to(dtype) for _ in range(4))
    mask = _mask(B, T)
    first = attention.attention_fwd(q, k, v, mask, nh, 0.1, 3)
    again = attention.attention_fwd(q, k, v, mask, nh, 0.1, 3)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    _, m, l = first
    grads = attention.attention_bwd(q, k, v, do, mask, m, l, nh, 0.1, 3)
    again = attention.attention_bwd(q, k, v, do, mask, m, l, nh, 0.1, 3)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


def test_attention_route_is_a_rule_on_dtype_and_length(gen):
    """bf16 with a head dim up to 256 goes to the tensor-core kernels at
    any length (up to T = 128 at head dim 64 the whole-head kernels, else
    the tiled ones), anything else to the FMA kernels; an unaligned view
    on the tensor-core route raises."""
    for dtype, T, H, nh, mma in (
        (torch.bfloat16, 128, 768, 12, 1), (torch.bfloat16, 129, 768, 12, 1), (torch.bfloat16, 1, 768, 12, 1),
        (torch.float32, 128, 768, 12, 0), (torch.float32, 8, 768, 12, 0),
        (torch.bfloat16, 600, 768, 3, 1), (torch.bfloat16, 40, 640, 2, 0), (torch.float32, 600, 768, 24, 0),
    ):
        q = torch.randn((2, T, H), generator=gen, device="cuda").to(dtype)
        attention.launches = attention.mma_launches = 0
        attention.bwd_launches = attention.mma_bwd_launches = 0
        _, m, l = attention.attention_fwd(q, q, q, None, nh)
        attention.attention_bwd(q, q, q, q, None, m, l, nh)
        assert (attention.launches, attention.bwd_launches) == (1, 1)
        assert (attention.mma_launches, attention.mma_bwd_launches) == (mma, mma), (dtype, T, H, nh)
    H, nh = 768, 12
    flat = torch.zeros(2 * 16 * H + 1, dtype=torch.bfloat16, device="cuda")
    odd = flat[1:].view(2, 16, H)  # contiguous, 2 bytes off a 16-byte boundary
    with pytest.raises(ValueError, match="aligned"):
        attention.attention_fwd(odd, odd, odd, None, nh)


GRID_DIMS = (8, 16, 40, 64, 128, 256, 320)
GRID_LENGTHS = (1, 77, 128, 136, 256, 512, 1024)


def _grid_mask(kind, B, T):
    """None, ragged rows (row 0 full), or ragged rows with the last row
    fully masked."""
    if kind is None:
        return None
    mask = torch.ones((B, T), dtype=torch.int32, device="cuda")
    for b in range(1, B):
        mask[b, max(1, T - (b * T) // (B + 1)):] = 0
    if kind == "fully_masked_row":
        mask[-1] = 0
    return mask


def keep_bits_read_back(B, nh, T, d, dtype, rate, seed):
    """The keep-mask bits as the kernels drew them: with q = k = 0 every p
    is 1; v's key j < d a one-hot in head dim j makes o[i, j] the kept
    p of (query i, key j) over l, and dO's query i < d a one-hot makes
    dv[j, i] that of (query i, key j). Returns (forward bits for keys
    < min(T, d), backward bits for queries < min(T, d)), [row, head,
    query, key]."""
    n = min(T, d)
    zeros = torch.zeros((B, T, nh * d), dtype=dtype, device="cuda")
    eye = torch.zeros((B, T, nh, d), dtype=dtype, device="cuda")
    eye[:, torch.arange(n), :, torch.arange(n)] = 1
    eye = eye.reshape(B, T, nh * d)
    o, m, l = attention.attention_fwd(zeros, zeros, eye, None, nh, rate, seed)
    _, _, dv = attention.attention_bwd(zeros, zeros, eye, eye, None, m, l, nh, rate, seed)
    fwd = o.reshape(B, T, nh, d)[..., :n].permute(0, 2, 1, 3) > 0
    bwd = dv.reshape(B, T, nh, d)[..., :n].permute(0, 2, 3, 1) > 0
    return fwd, bwd


@pytest.mark.parametrize("T", GRID_LENGTHS)
@pytest.mark.parametrize("d", GRID_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_pair_over_head_dims_and_lengths(gen, dtype, d, T):
    """Every shape of the grid launches the kernel its route names, never
    raises, and agrees with the plain versions under no mask, ragged
    rows and a fully masked row, at rate 0 and 0.1; the keep bits read
    back from both kernels equal the plain version's."""
    B, nh = 3, 2
    route = attention.kernel_route(dtype, d)
    q, k, v, do = (torch.randn((B, T, nh * d), generator=gen, device="cuda").to(dtype) for _ in range(4))
    for kind in (None, "ragged", "fully_masked_row"):
        mask = _grid_mask(kind, B, T)
        for rate in (0.0, 0.1):
            attention.launches = attention.mma_launches = attention.bwd_launches = attention.mma_bwd_launches = 0
            o, m, l = attention.attention_fwd(q, k, v, mask, nh, rate, 21)
            grads = attention.attention_bwd(q, k, v, do, mask, m, l, nh, rate, 21)
            torch.cuda.synchronize()
            mma = int(route == "mma")
            assert (attention.launches, attention.bwd_launches) == (1, 1)
            assert (attention.mma_launches, attention.mma_bwd_launches) == (mma, mma)
            ro, rm, rl = attention.attention_reference(q, k, v, mask, nh, rate, 21)
            where = f"{dtype} d {d} T {T} mask {kind} rate {rate}"
            torch.testing.assert_close(o.float(), ro.float(), msg=f"o {where}", **OUT_TOL[dtype])
            torch.testing.assert_close(m, rm, rtol=1e-4, atol=1e-5, msg=f"m {where}")
            torch.testing.assert_close(l, rl, rtol=1e-4, atol=0, msg=f"l {where}")
            want = attention.attention_bwd_reference(q, k, v, do, mask, m, l, nh, rate, 21)
            for name, g, w in zip(("dq", "dk", "dv"), grads, want):
                torch.testing.assert_close(g.float(), w.float(), msg=f"{name} {where}", **GRAD_TOL[dtype])
    fwd, bwd = keep_bits_read_back(B, nh, T, d, dtype, 0.1, 21)
    keep = attention.keep_mask(B, nh, T, 21, 0.1, "cuda")
    n = min(T, d)
    assert torch.equal(fwd, keep[..., :n]) and torch.equal(bwd, keep[..., :n, :])


@pytest.mark.parametrize("x_dtype,w_dtype", [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
                                             (torch.float16, torch.float32), (torch.bfloat16, torch.bfloat16)])
# widths of both routes (a warp per row up to 1024 in whole 16-byte pieces,
# else a block per row, up to the widest the wrapper takes) and row counts
# of one row and one row over a block of the warp route
@pytest.mark.parametrize("n,d", [(1, 64), (7, 100), (1000, 768), (33, 1000), (16, 4096),
                                 (1, 768), (layernorm.WARP_ROWS + 1, 768), (9, 1024), (3, 1028),
                                 (9, 770), (2, 65536), (1, 1)])
def test_layernorm_kernel_matches_plain(gen, n, d, x_dtype, w_dtype):
    x = (torch.randn((n, d), generator=gen, device="cuda") * 3 + 0.5).to(x_dtype)
    scale = (1 + 0.1 * torch.randn((d,), generator=gen, device="cuda")).to(w_dtype)
    bias = (0.1 * torch.randn((d,), generator=gen, device="cuda")).to(w_dtype)
    layernorm.launches = 0
    got = layernorm.layernorm_fwd(x, scale, bias, 1e-12)
    torch.cuda.synchronize()
    assert layernorm.launches == 1
    want = layernorm.layernorm_reference(x, scale, bias, 1e-12)
    assert got[0].dtype == want[0].dtype == torch.promote_types(x_dtype, w_dtype)
    tol = dict(rtol=1e-5, atol=1e-5) if got[0].dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(got[0], want[0], **tol)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=0)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(1, 64), (7, 100), (1000, 768), (32768, 768), (33, 1000), (130, 4096)])
def test_layernorm_backward_matches_plain(gen, n, d, x_dtype):
    x = (torch.randn((n, d), generator=gen, device="cuda") * 3 + 0.5).to(x_dtype)
    dy = torch.randn((n, d), generator=gen, device="cuda")
    scale = 1 + 0.1 * torch.randn((d,), generator=gen, device="cuda")
    bias = 0.1 * torch.randn((d,), generator=gen, device="cuda")
    _, mean, rstd = layernorm.layernorm_reference(x, scale, bias, 1e-12)
    layernorm.bwd_launches = 0
    got = layernorm.layernorm_bwd(dy, x, mean, rstd, scale, bias)
    torch.cuda.synchronize()
    assert layernorm.bwd_launches == 1
    want = layernorm.layernorm_bwd_reference(dy, x, mean, rstd, scale, bias)
    assert got[0].dtype == x_dtype and got[1].dtype == got[2].dtype == torch.float32
    tol = dict(rtol=1e-4, atol=1e-4) if x_dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(got[0], want[0], msg="dx", **tol)
    for name, g, w in zip(("dgamma", "dbeta"), got[1:], want[1:]):
        torch.testing.assert_close(g, w, msg=name, rtol=1e-4, atol=1e-3)


def test_layernorm_function_against_autograd_of_plain(gen):
    x = (torch.randn((512, 768), generator=gen, device="cuda") * 2).requires_grad_(True)
    scale = (1 + 0.1 * torch.randn((768,), generator=gen, device="cuda")).requires_grad_(True)
    bias = (0.1 * torch.randn((768,), generator=gen, device="cuda")).requires_grad_(True)
    dy = torch.randn((512, 768), generator=gen, device="cuda")
    layernorm.launches = layernorm.bwd_launches = 0
    layernorm.fused_layernorm(x, scale, bias).backward(dy)
    assert (layernorm.launches, layernorm.bwd_launches) == (1, 1)
    got = [t.grad for t in (x, scale, bias)]
    plain = [t.detach().clone().requires_grad_(True) for t in (x, scale, bias)]
    layernorm.layernorm_reference(*plain, 1e-12)[0].backward(dy)
    for name, g, p in zip(("dx", "dgamma", "dbeta"), got, plain):
        torch.testing.assert_close(g, p.grad, msg=name, rtol=1e-4, atol=1e-3)


def test_layernorm_forward_takes_an_unaligned_view_and_feeds_the_backward(gen):
    """x at an offset of one element is off a 16-byte boundary: the block
    route takes it. The forward's mean and rstd, halves of one allocation,
    are what the backward accepts."""
    flat = torch.randn(1 + 6 * 768, generator=gen, device="cuda")
    x = flat[1:].view(6, 768)
    w = 1 + 0.1 * torch.randn((768,), generator=gen, device="cuda")
    b = 0.1 * torch.randn((768,), generator=gen, device="cuda")
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    got = layernorm.layernorm_fwd(x, w, b, 1e-12)
    want = layernorm.layernorm_reference(x, w, b, 1e-12)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)
    dy = torch.randn((6, 768), generator=gen, device="cuda")
    dx = layernorm.layernorm_bwd(dy, x, got[1], got[2], w, b)[0]
    torch.testing.assert_close(dx, layernorm.layernorm_bwd_reference(dy, x, *want[1:], w, b)[0],
                               rtol=1e-4, atol=1e-4)
    empty = layernorm.layernorm_fwd(x[:0], w, b, 1e-12)
    assert [tuple(t.shape) for t in empty] == [(0, 768), (0, 1), (0, 1)]


def test_layernorm_wrapper_refuses(gen):
    x = torch.zeros((8, 64), device="cuda")
    with pytest.raises(ValueError):
        layernorm.layernorm_fwd(x.t(), torch.ones(8, device="cuda"), torch.zeros(8, device="cuda"), 1e-12)
    with pytest.raises(ValueError):
        layernorm.layernorm_fwd(x, torch.ones(64), torch.zeros(64), 1e-12)
    with pytest.raises(ValueError):
        layernorm.layernorm_fwd(x.long(), torch.ones(64, device="cuda"), torch.zeros(64, device="cuda"), 1e-12)
    w, stat = torch.ones(64, device="cuda"), torch.zeros((8, 1), device="cuda")
    layernorm.bwd_launches = 0
    with pytest.raises(ValueError, match="dy"):
        layernorm.layernorm_bwd(x[:4], x, stat, stat, w, w)
    with pytest.raises(ValueError, match="rstd"):
        layernorm.layernorm_bwd(x, x, stat, stat[:4], w, w)
    assert layernorm.bwd_launches == 0


# T = 77 is off the JAX fused path's shapes (T % 8), but on the card
# fused_attention still launches the kernel, once per layer; 8 heads of
# 32 and T = 320 take the tiled tensor-core kernels in bf16
@pytest.mark.parametrize("T,heads", [(128, 12), (77, 12), (320, 12), (128, 24)])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_bert_encoder_kernels_on_vs_off(gen, dtype, T, heads):
    cfg = bert.BertConfig(vocab_size=512, num_layers=2, num_heads=heads)
    off = bert.BertEncoder(cfg, dtype=dtype, device="cuda", generator=gen).eval()
    on = bert.BertEncoder(dataclasses.replace(cfg, fused_attention=True, fused_ln=True),
                          dtype=dtype, device="cuda")
    on.load_state_dict(off.state_dict())
    ids = torch.randint(0, 512, (4, T), device="cuda", generator=gen)
    mask = _mask(4, T)
    attention.launches = layernorm.launches = 0
    with torch.no_grad():
        a, b = on(ids, mask), off(ids, mask)
    assert (attention.launches, layernorm.launches) == (2, 5)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype is None else dict(rtol=0.1, atol=0.1)
    torch.testing.assert_close(a, b, **tol)


def test_bert_encoder_backward_kernels_on_vs_off(gen):
    """A forward with grad (dropout off) and a backward: the gradients of
    every parameter with both kernels against neither, in f32."""
    cfg = bert.BertConfig(vocab_size=512, num_layers=2)
    off = bert.BertEncoder(cfg, device="cuda", generator=gen)
    on = bert.BertEncoder(dataclasses.replace(cfg, fused_attention=True, fused_ln=True), device="cuda")
    on.load_state_dict(off.state_dict())
    ids = torch.randint(0, 512, (4, 128), device="cuda", generator=gen)
    mask = _mask(4, 128)
    dy = torch.randn((4, 128, 768), generator=gen, device="cuda")
    attention.launches = attention.bwd_launches = layernorm.launches = layernorm.bwd_launches = 0
    on(ids, mask).backward(dy)
    off(ids, mask).backward(dy)
    assert (attention.launches, attention.bwd_launches) == (2, 2)
    assert (layernorm.launches, layernorm.bwd_launches) == (5, 5)
    grads_off = dict(off.named_parameters())
    for name, p in on.named_parameters():
        torch.testing.assert_close(p.grad, grads_off[name].grad, rtol=1e-3, atol=1e-4, msg=name)


def test_bert_training_forward_draws_attention_seeds_on_the_host(gen):
    """With dropout on and fused attention, each layer's seed comes from
    the CPU generator: the same host seed replays the same output."""
    cfg = bert.BertConfig(vocab_size=512, num_layers=2, fused_attention=True, fused_ln=True,
                          dropout_bits=16, gelu_output_bwd=True)
    enc = bert.BertEncoder(cfg, dtype=torch.bfloat16, device="cuda", generator=gen)
    ids = torch.randint(0, 512, (4, 128), device="cuda", generator=gen)
    mask = _mask(4, 128)
    outs = []
    for host_seed in (1, 1, 2):
        attention.dropout_launches = 0
        with torch.no_grad():
            outs.append(enc(ids, mask, deterministic=False,
                            generator=torch.Generator(device="cuda").manual_seed(3),
                            host_generator=torch.Generator().manual_seed(host_seed)))
        assert attention.dropout_launches == 2
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    with pytest.raises(ValueError, match="host_generator"):
        enc(ids, mask, deterministic=False)



# ------------------------------------------------------------- vq_argmin


def _argmin_agrees(got, want, x, cb):
    differ = (got != want).nonzero().flatten()
    if differ.numel():
        cbd = cb.double()
        scores = (cbd * cbd).sum(dim=1)[None, :] - 2.0 * x[differ].double() @ cbd.t()
        span = scores.amax(dim=1) - scores.amin(dim=1)
        a = scores.gather(1, got[differ].long()[:, None])[:, 0]
        b = scores.gather(1, want[differ].long()[:, None])[:, 0]
        assert ((a - b).abs() / span).max().item() <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["normal", "taming"])
@pytest.mark.parametrize("n,k,d", [(64, 16384, 256), (1, 64, 256), (65, 65, 33), (1000, 1000, 256),
                                   (37, 32, 8), (300, 5000, 1), (4096, 16384, 256)])
def test_vq_argmin_kernel_matches_plain(gen, n, k, d, kind, dtype):
    if kind == "taming":
        cb = (torch.rand((k, d), generator=gen, device="cuda") * 2 - 1) / k
        x = cb[torch.randint(0, k, (n,), generator=gen, device="cuda")] \
            + (torch.rand((n, d), generator=gen, device="cuda") - 0.5) / k
    else:
        cb = torch.randn((k, d), generator=gen, device="cuda")
        x = torch.randn((n, d), generator=gen, device="cuda")
    x = x.to(dtype)
    vq_argmin.launches = 0
    got = vq_argmin.vq_argmin(x, cb)
    torch.cuda.synchronize()
    assert vq_argmin.launches == 1 and got.dtype == torch.int32 and got.shape == (n,)
    assert 0 <= int(got.min()) and int(got.max()) < k
    _argmin_agrees(got, vq_argmin.vq_argmin_reference(x, cb), x, cb)
    assert torch.equal(got, vq_argmin.vq_argmin(x, cb))  # the atomics' order does not show


@pytest.mark.parametrize("n,k,d", [(64, 16384, 256), (130, 2100, 128)])
def test_vq_argmin_ties_go_to_the_lowest_index(gen, n, k, d):
    cb = torch.randint(-2, 3, (k, d), generator=gen, device="cuda").float()
    cb[k - 1], cb[k // 2 + 3], cb[k - 70] = cb[5], cb[5], cb[64]
    x = torch.randint(-2, 3, (n, d), generator=gen, device="cuda").float()
    x[0], x[1], x[2] = cb[5], cb[64], cb[k - 1]
    got = vq_argmin.vq_argmin(x, cb)
    assert got[:3].tolist() == [5, 64, 5]
    assert torch.equal(got, vq_argmin.vq_argmin_reference(x, cb))
    # brute force in f64, exact for these integers: the least index at the minimum
    scores = (cb.double() ** 2).sum(dim=1)[None, :] - 2 * x.double() @ cb.double().t()
    first = torch.where(scores == scores.amin(dim=1, keepdim=True), torch.arange(k, device="cuda"), k)
    assert torch.equal(got.long(), first.amin(dim=1))
    rows = torch.arange(0, k, 64, device="cuda")
    normal = torch.randn((k, d), generator=gen, device="cuda")
    assert torch.equal(vq_argmin.vq_argmin(normal[rows].contiguous(), normal).long(), rows)


def _integer_case(gen, n, k, d):
    cb = torch.randint(-2, 3, (k, d), generator=gen, device="cuda").float()
    return torch.randint(-2, 3, (n, d), generator=gen, device="cuda").float(), cb


def test_vq_argmin_calls_in_a_row_share_one_scratch(gen):
    """Launched back to back on one stream, a larger call before a smaller
    one: each finds the scratch buffer as new, and the last leaves it so."""
    cb = _integer_case(gen, 1, 5000, 128)[1]
    calls = [_integer_case(gen, n, 1, 128)[0] for n in (300, 64, 64, 1000, 1)]
    outs = [vq_argmin.vq_argmin(x, cb) for x in calls]
    torch.cuda.synchronize()
    for x, out in zip(calls, outs):
        assert torch.equal(out, vq_argmin.vq_argmin_reference(x, cb))
    keys, tickets = vq_argmin._scratch[0, torch.cuda.current_stream().cuda_stream]
    assert keys.shape[0] >= 1000 and bool((keys == -1).all()) and int(tickets.count_nonzero()) == 0


def test_vq_argmin_second_stream_gets_its_own_scratch(gen):
    x, cb = _integer_case(gen, 130, 2100, 128)
    want = vq_argmin.vq_argmin_reference(x, cb)
    assert torch.equal(vq_argmin.vq_argmin(x, cb), want)
    here, side = torch.cuda.current_stream(), torch.cuda.Stream()
    side.wait_stream(here)
    with torch.cuda.stream(side):
        got = vq_argmin.vq_argmin(x, cb)
    side.synchronize()
    assert torch.equal(got, want)
    mine, its = vq_argmin._scratch[0, here.cuda_stream], vq_argmin._scratch[0, side.cuda_stream]
    assert here.cuda_stream != side.cuda_stream and mine[0].data_ptr() != its[0].data_ptr()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vq_argmin_equals_the_plain_3xtf32_version_on_exact_inputs(gen, dtype):
    x, cb = _integer_case(gen, 200, 3000, 256)
    got = vq_argmin.vq_argmin(x.to(dtype), cb)
    assert torch.equal(got, vq_argmin.vq_argmin_reference_3xtf32(x.to(dtype), cb))


def test_vq_argmin_wrapper_refuses_and_quantize_switches(gen):
    x, cb = torch.zeros((4, 8), device="cuda"), torch.zeros((16, 8), device="cuda")
    vq_argmin.launches = 0
    for bad_x, bad_cb in ((x.half(), cb), (x, cb.bfloat16()), (x.t(), cb), (x, cb[:, :4]),
                          (x[None], cb), (x, cb.cpu()), (x[:0], cb)):
        with pytest.raises((ValueError, TypeError)):
            vq_argmin.vq_argmin(bad_x, bad_cb)
    assert vq_argmin.launches == 0
    z = torch.randn((2, 3, 4, 8), generator=gen, device="cuda", requires_grad=True)
    cb = torch.randn((16, 8), generator=gen, device="cuda")
    out = quantize.vector_quantize(z, cb)
    assert vq_argmin.launches == 1
    plain = quantize.vector_quantize(z, cb, use_kernel=False)
    assert vq_argmin.launches == 1 and torch.equal(out, plain)
    out.backward(torch.ones_like(out))
    assert torch.equal(z.grad, torch.ones_like(z))


# --------------------------------------------------------- scanline_lerp


def _coords(gen, S, O, K, kind):
    if kind == "wild":
        return torch.rand((S, O), generator=gen, device="cuda") * (K + 40) - 20
    steps = torch.rand((S, O), generator=gen, device="cuda") * (1.1 * K / O) + 0.45 * K / O
    coords = steps.cumsum(dim=1) - 2.0
    return coords.flip(1).contiguous() if kind == "decreasing" else coords


@pytest.mark.parametrize("kind", ["increasing", "decreasing", "wild"])
@pytest.mark.parametrize("S,C,K,O", [(4096, 3, 128, 128), (4096, 3, 128, 224), (600, 3, 200, 224),
                                     (7, 1, 2, 5), (33, 4, 17, 300), (1, 3, 128, 1)])
def test_scanline_lerp_kernel_matches_plain(gen, S, C, K, O, kind):
    src = torch.rand((S, C, K), generator=gen, device="cuda")
    coords = _coords(gen, S, O, K, kind)
    scanline_lerp.launches = 0
    got = scanline_lerp.scanline_lerp_fwd(src[None], coords)[0]
    torch.cuda.synchronize()
    assert scanline_lerp.launches == 1 and got.shape == (S, C, O) and got.is_contiguous()
    torch.testing.assert_close(got, scanline_lerp.scanline_lerp_reference(src, coords), rtol=0, atol=1e-6)


def test_scanline_lerp_takes_strided_four_d_views(gen):
    img = torch.rand((8, 32, 40, 3), generator=gen, device="cuda")  # N, H, W, C
    coords = _coords(gen, 8 * 32, 50, 40, "increasing")
    view = img.permute(0, 1, 3, 2)  # (N, H, C, W)
    got = scanline_lerp.scanline_lerp(view, coords)
    want = scanline_lerp.scanline_lerp_reference(view.reshape(8 * 32, 3, 40), coords)
    torch.testing.assert_close(got.reshape(want.shape), want, rtol=0, atol=1e-6)
    coords2 = _coords(gen, 8 * 50, 20, 32, "decreasing")
    view2 = got.permute(0, 3, 2, 1)  # (N, Wo, C, H): pass 2's source
    got2 = scanline_lerp.scanline_lerp(view2, coords2)
    want2 = scanline_lerp.scanline_lerp_reference(view2.reshape(8 * 50, 3, 32), coords2)
    torch.testing.assert_close(got2.reshape(want2.shape), want2, rtol=0, atol=1e-6)


def test_scanline_lerp_function_against_autograd_of_the_tent_product(gen):
    S, C, K, O = 512, 3, 128, 224
    src = torch.rand((S, C, K), generator=gen, device="cuda", requires_grad=True)
    coords = _coords(gen, S, O, K, "increasing").requires_grad_(True)
    cot = torch.randn((S, C, O), generator=gen, device="cuda")
    scanline_lerp.launches = 0
    scanline_lerp.scanline_lerp(src, coords).backward(cot)
    assert scanline_lerp.launches == 1 and coords.grad is None
    leaf = src.detach().clone().requires_grad_(True)
    dense = torch.einsum("sok,sck->sco", scanline_lerp.tent_weights(coords.detach(), K), leaf)
    dense.backward(cot)
    torch.testing.assert_close(src.grad, leaf.grad, rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(src.grad, scanline_lerp.scanline_lerp_bwd(cot, coords.detach(), K), rtol=0, atol=0)


def test_scanline_lerp_wrapper_refuses(gen):
    src, coords = torch.zeros((1, 4, 3, 8), device="cuda"), torch.zeros((4, 5), device="cuda")
    scanline_lerp.launches = 0
    for bad_src, bad_coords in ((src[..., :1], coords), (src, coords[:3]), (src.double(), coords),
                                (src, coords.cpu())):
        with pytest.raises(ValueError):
            scanline_lerp.scanline_lerp_fwd(bad_src, bad_coords)
    assert scanline_lerp.launches == 0


# ---------------------------------------------------------- the v2 step


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_v2_step_kernels_on_vs_off(gen, dtype):
    """One step of a small engine (CLIP at 64 px, 4 cutouts) from the same
    state and draws: the argmin kernel against the plain version (equal
    up to rounding: 1e-4 f32), and the scanline-kernel warp against the
    dense one (its bf16 rounding: losses 2e-2)."""
    import dataclasses

    from imagegenerator_tpu_torch.v2.clip import CLIPConfig
    from imagegenerator_tpu_torch.v2.engine import GenerateEngine
    from imagegenerator_tpu_torch.v2.vqgan import VQGANConfig

    vq_cfg = dataclasses.replace(VQGANConfig.tiny(), ch=32, embed_dim=64, z_channels=64, n_embed=1000)
    clip_cfg = dataclasses.replace(CLIPConfig.tiny(), image_resolution=64, vision_width=64, text_width=64)
    base = GenerateEngine(vq_cfg, clip_cfg, cutn=4, compute_dtype=dtype, warp_kernel=True,
                          device="cuda", generator=gen)
    states = (base.vqmodel.state_dict(), base.clip.state_dict())
    others = {
        "plain argmin": GenerateEngine(vq_cfg, clip_cfg, *states, cutn=4, compute_dtype=dtype,
                                       warp_kernel=True, use_vq_kernel=False, device="cuda"),
        "dense warp": GenerateEngine(vq_cfg, clip_cfg, *states, cutn=4, compute_dtype=dtype,
                                     warp_kernel=False, device="cuda"),
    }
    z0 = base.random_token_latent(gen, 2, 16, 16)
    prompts = (torch.randn((2, 2, 16), generator=gen, device="cuda"),
               torch.tensor([[1.0, -0.5], [0.7, 0.0]], device="cuda"),
               torch.full((2, 2), -float("inf"), device="cuda"))
    draws = base.make_cutouts.draw(gen, base.image_shape(z0), "cuda")
    vq_argmin.launches = scanline_lerp.launches = 0
    state, losses = base.step(base.init_state(z0), None, *prompts, draws=draws)
    assert (vq_argmin.launches, scanline_lerp.launches) == (1, 2)
    grad = state.z.grad.clone()
    assert torch.isfinite(losses).all() and torch.isfinite(grad).all()
    tol = 1e-4 if dtype is None else 2e-2
    for name, engine in others.items():
        other, other_losses = engine.step(engine.init_state(z0), None, *prompts, draws=draws)
        rel = ((grad - other.z.grad).norm() / other.z.grad.norm()).item()
        if name == "plain argmin":
            torch.testing.assert_close(losses, other_losses, rtol=tol, atol=tol)
            assert rel <= tol
        else:
            torch.testing.assert_close(losses, other_losses, rtol=2e-2, atol=2e-2)
    assert (vq_argmin.launches, scanline_lerp.launches) == (2, 4)
