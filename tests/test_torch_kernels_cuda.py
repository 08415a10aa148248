"""The port's hand-written kernels against their plain versions on a CUDA
card: the attention forward (CUDA C++) over the sequence lengths it
takes, up to 512, and the LayerNorm forward (Triton) over widths, row
counts and dtypes; the wrappers' launch counts and refusals; and the BERT
encoder with the kernels on against off. Marked ``cuda``: skipped where
there is no card. On a card, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest configures JAX, which the card's
machine need not have; these tests import only PyTorch and the port.)

Tolerances as in ``chip_smoke.py``: attention o rtol 1e-4 / atol 1e-5 in
f32 and 2e-2 / 2e-2 in bf16, m and l rtol 1e-4; LayerNorm y rtol = atol
= 1e-5, mean and rstd rtol 1e-5."""

import dataclasses

import pytest
import torch

from imagegenerator_tpu_torch.models import bert
from imagegenerator_tpu_torch.ops.kernels import attention, layernorm

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,with_mask", [(8, 128, True), (3, 40, True), (2, 8, True),
                                           (2, 256, False), (2, 512, True), (1, 72, False),
                                           (4, 77, True), (2, 1, False)])
def test_attention_kernel_matches_plain(gen, B, T, with_mask, dtype):
    H, nh = 768, 12
    q, k, v = (torch.randn((B, T, H), generator=gen, device="cuda").to(dtype) for _ in range(3))
    mask = _mask(B, T) if with_mask else None
    attention.launches = 0
    got = attention.attention_fwd(q, k, v, mask, nh)
    torch.cuda.synchronize()
    assert attention.launches == 1
    want = attention.attention_reference(q, k, v, mask, nh)
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(got[0].float(), want[0].float(), **tol)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=0)


@pytest.mark.parametrize(
    "shape,nh,dtype,mask_dtype",
    [((2, 16, 384), 12, torch.float32, torch.int32),   # head dim 32
     ((2, 520, 768), 12, torch.float32, torch.int32),  # T > 512
     ((2, 0, 768), 12, torch.float32, torch.int32),    # T == 0
     ((2, 16, 768), 8, torch.float32, torch.int32),    # head dim 96
     ((2, 16, 768), 12, torch.float16, torch.int32),   # dtype
     ((2, 16, 768), 12, torch.float32, torch.int64)],  # mask dtype
)
def test_attention_wrapper_refuses(gen, shape, nh, dtype, mask_dtype):
    q = torch.zeros(shape, dtype=dtype, device="cuda")
    mask = torch.ones(shape[:2], dtype=mask_dtype, device="cuda")
    attention.launches = 0
    with pytest.raises((ValueError, TypeError)):
        attention.attention_fwd(q, q, q, mask, nh)
    with pytest.raises(ValueError):
        attention.attention_fwd(q.transpose(0, 1), q, q, None, nh)
    with pytest.raises(NotImplementedError):
        attention.fused_attention(q, q, q, None, num_heads=nh, dropout_rate=0.1)
    assert attention.launches == 0


@pytest.mark.parametrize("x_dtype,w_dtype", [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
                                             (torch.float16, torch.float32), (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("n,d", [(1, 64), (7, 100), (1000, 768), (33, 1000), (16, 4096)])
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


def test_layernorm_wrapper_refuses(gen):
    x = torch.zeros((8, 64), device="cuda")
    with pytest.raises(ValueError):
        layernorm.layernorm_fwd(x.t(), torch.ones(8, device="cuda"), torch.zeros(8, device="cuda"), 1e-12)
    with pytest.raises(ValueError):
        layernorm.layernorm_fwd(x, torch.ones(64), torch.zeros(64), 1e-12)
    with pytest.raises(ValueError):
        layernorm.layernorm_fwd(x.long(), torch.ones(64, device="cuda"), torch.zeros(64, device="cuda"), 1e-12)


# T = 77 is off the JAX fused path's shapes (T % 8), but on the card
# fused_attention still launches the kernel, once per layer
@pytest.mark.parametrize("T", [128, 77])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_bert_encoder_kernels_on_vs_off(gen, dtype, T):
    cfg = bert.BertConfig(vocab_size=512, num_layers=2)
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

