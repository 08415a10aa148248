"""``ops/conv.py::conv2d`` on the CPU, the ``autograd.Function`` every
``Conv2d`` runs through: its forward is ``F.conv2d`` and its backward
``aten.convolution_backward``, so forward and backward equal
``F.conv2d``'s bit for bit, in f32 and bf16, channels-last and not; its
own backward, the penalty's second order written out, is held to aten's
double backward in float64, f32 and bf16; ``gradcheck`` and
``gradgradcheck`` in float64 at each of the nets' geometries; the
penalty's weight gradients through two layers against ``F.conv2d``'s; a
penalty in the input alone forms no weight gradient, nor a first-order
gradient in the input alone, and one through a leaf weight matches
``F.conv2d``'s; a call autograd does not record is ``F.conv2d`` itself;
every convolution shape of G2, D2 and D1 at the configurations' widths.
On a card
(``tests/test_torch_kernels_cuda.py``): a critic iteration's penalty
gradients against aten's and f32's."""

import pytest
import torch
import torch.nn.functional as F

from imagegenerator_tpu_torch.ops import conv as conv_ops
from imagegenerator_tpu_torch.ops import layers

torch.set_num_threads(2)
BF16, F32 = torch.bfloat16, torch.float32
CL = torch.channels_last
# (kernel size, stride, padding) of the nets' convolutions: the residual
# blocks' 3x3, the DownBlocks' 4x4 stride 2, the critics' 1x1 heads
GEOMETRIES = [(1, 1, 0), (3, 1, 1), (4, 2, 1)]


def _cl(shape, dtype=BF16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype).contiguous(memory_format=CL)


def _plain(x, w, b=None, *, stride=1, padding=0):
    return F.conv2d(x, w, b, stride=stride, padding=padding)


# ------------------------------------------------------------------ the Function
CASES = [((2, 16, 8, 8), 32, (3, 1, 1)), ((2, 32, 8, 6), 16, (4, 2, 1)), ((3, 48, 4, 4), 24, (1, 1, 0)),
         ((1, 3, 8, 8), 16, (4, 2, 1))]


def _operands(shape, c_out, k, dtype, layout, bias, seed=0):
    g = torch.Generator().manual_seed(seed)
    fmt = CL if layout == "channels_last" else torch.contiguous_format
    x = torch.randn(shape, generator=g).to(dtype).contiguous(memory_format=fmt)
    w = (torch.randn((c_out, shape[1], k, k), generator=g) / (shape[1] * k * k) ** 0.5).to(dtype)
    w = w.contiguous(memory_format=fmt)
    b = (0.1 * torch.randn(c_out, generator=g)).to(dtype) if bias else None
    return x, w, b


def _first_and_second_order(fn, shape, c_out, geometry, dtype, layout, bias, create_graph):
    """``[y, gx, gw, (gb)]`` of ``fn`` on seeded operands, and with
    ``create_graph`` the penalty-shaped second order: the input gradient's
    squared norm differentiated in x, w (and b)."""
    k, s, p = geometry
    x, w, b = _operands(shape, c_out, k, dtype, layout, bias)
    leaves = [t.requires_grad_(True) for t in (x, w, b) if t is not None]
    y = fn(x, w, b, stride=s, padding=p)
    probe = torch.randn(y.shape, generator=torch.Generator().manual_seed(1)).to(dtype)
    first = torch.autograd.grad(y, leaves, probe, create_graph=create_graph)
    if not create_graph:
        return [y, *first]
    return list(torch.autograd.grad(first[0].float().square().sum(), leaves, allow_unused=True))


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_function_equals_conv2d_bit_for_bit(case, dtype, layout, bias):
    """Forward and backward (x, w, b) through ``conv_ops.conv2d`` on the CPU
    against ``F.conv2d`` under autograd: equal bits, equal memory format
    (the same aten calls)."""
    shape, c_out, geometry = CASES[case]
    got = _first_and_second_order(conv_ops.conv2d, shape, c_out, geometry, dtype, layout, bias, False)
    want = _first_and_second_order(_plain, shape, c_out, geometry, dtype, layout, bias, False)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.is_contiguous(memory_format=CL) == b.is_contiguous(memory_format=CL)
        assert torch.equal(a, b)


# the second order's distance from aten's: float64 and f32 round the same
# sums in another order (``_convolution_double_backward`` forms the weight
# term as a convolution over the whole map); bf16 rounds each term's output
# to 8 bits, a relative 2^-9, and adds two of them
SECOND_ORDER_TOL = {torch.float64: 1e-12, F32: 1e-5, BF16: 2.0 ** -7}


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, F32, BF16])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_function_second_order_matches_conv2d(case, dtype, bias):
    """The penalty-shaped second order through ``_Conv2dGrad``'s backward
    against ``F.conv2d``'s (aten's double backward), channels-last: each
    gradient within ``SECOND_ORDER_TOL`` of aten's in norm."""
    shape, c_out, geometry = CASES[case]
    got = _first_and_second_order(conv_ops.conv2d, shape, c_out, geometry, dtype, "channels_last", bias, True)
    want = _first_and_second_order(_plain, shape, c_out, geometry, dtype, "channels_last", bias, True)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is None:
            continue
        assert a.dtype == b.dtype and a.shape == b.shape
        rel = ((a.double() - b.double()).norm() / b.double().norm()).item()
        assert rel <= SECOND_ORDER_TOL[dtype], rel


def test_function_routes_each_layers_conv_through_it(monkeypatch):
    """``layers.Conv2d`` reaches ``conv_ops.conv2d``, whose forward calls
    ``F.conv2d`` once, and its output's node is the Function's."""
    seen = []
    plain = F.conv2d

    def spy(*args, **kw):
        seen.append(args[0].shape)
        return plain(*args, **kw)

    monkeypatch.setattr(conv_ops.F, "conv2d", spy)
    layer = layers.Conv2d(16, 32, 3, 1, 1, dtype=BF16)
    x = _cl((2, 16, 8, 8))
    y = layer(x)
    assert seen == [x.shape] and y.is_contiguous(memory_format=CL)
    assert y.grad_fn is not None and type(y.grad_fn).__name__ == "_Conv2dBackward"


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_function_gradcheck_and_gradgradcheck_in_float64(geometry, bias):
    k, s, p = geometry
    x, w, b = _operands((2, 3, 6, 6), 4, k, torch.float64, "channels_last", bias, seed=3)
    leaves = tuple(t.requires_grad_(True) for t in (x, w, b) if t is not None)

    def fn(*ts):
        return conv_ops._Conv2d.apply(ts[0], ts[1], ts[2] if bias else None, s, p)

    assert torch.autograd.gradcheck(fn, leaves)
    assert torch.autograd.gradgradcheck(fn, leaves)


def test_function_penalty_second_order_matches_f_conv2d_in_float64():
    """A WGAN-GP-shaped penalty through two stacked Functions (a k4 s2
    layer then a k3 one): its gradient in every weight equals
    ``F.conv2d``'s to float64 rounding."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn((2, 16, 8, 8), generator=g, dtype=torch.float64).contiguous(memory_format=CL)
    w1 = torch.randn((16, 16, 4, 4), generator=g, dtype=torch.float64, requires_grad=True)
    w2 = torch.randn((8, 16, 3, 3), generator=g, dtype=torch.float64, requires_grad=True)
    grads = []
    for c2d in (lambda *a: conv_ops._Conv2d.apply(*a), lambda x, w, b, s, p: F.conv2d(x, w, b, s, p)):
        xi = x.clone().requires_grad_(True)
        out = c2d(F.leaky_relu(c2d(xi, w1, None, 2, 1), 0.1), w2, None, 1, 1).sum()
        (gx,) = torch.autograd.grad(out, xi, create_graph=True)
        gp = (gx.flatten(1).norm(dim=1) - 1).square().mean()
        grads.append(torch.autograd.grad(gp, [w1, w2]))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_penalty_in_the_input_alone_forms_no_weight_gradient(monkeypatch):
    """``autograd.grad`` in the input with ``create_graph`` (the penalty's
    first pass) asks ``aten.convolution_backward`` for the input gradient
    alone, as aten's own node does: the weight is a cast of a parameter,
    whose node the engine will not run."""
    masks = []
    backward = conv_ops._backward

    def spy(gy, x, w, stride, padding, mask):
        masks.append(list(mask))
        return backward(gy, x, w, stride, padding, mask)

    monkeypatch.setattr(conv_ops, "_backward", spy)
    layer = layers.Conv2d(16, 32, 4, 2, 1, dtype=BF16)
    x = _cl((2, 16, 8, 8), dtype=F32).requires_grad_(True)
    (gx,) = torch.autograd.grad(layer(x).float().sum(), x, create_graph=True)
    assert masks == [[True, False, False]]
    gx.square().sum().backward()
    assert layer.weight.grad is not None and layer.bias.grad is None
    assert masks[1:] == [[False, True, False]]


def test_penalty_through_a_leaf_weight_matches_f_conv2d(monkeypatch):
    """In f32 on a contiguous input the layer's weight and bias are the
    parameters themselves (no cast), leaves whose node the engine cannot
    be asked about during ``autograd.grad``: the penalty's first pass then
    forms their gradients too, unused, and every gradient of the first
    order and of the penalty equals ``F.conv2d``'s (the second order to
    ``SECOND_ORDER_TOL``)."""
    masks = []
    backward = conv_ops._backward

    def spy(gy, x, w, stride, padding, mask):
        masks.append(list(mask))
        return backward(gy, x, w, stride, padding, mask)

    monkeypatch.setattr(conv_ops, "_backward", spy)
    layer = layers.Conv2d(16, 32, 4, 2, 1)
    x0 = torch.randn((2, 16, 8, 8), generator=torch.Generator().manual_seed(5))
    assert layers._conv_operands(layer, x0)[1] is layer.weight
    params = [layer.weight, layer.bias]
    got, want = [], []
    for route, out in ((got, lambda x: layer(x)), (want, lambda x: F.conv2d(x, *params, 2, 1))):
        x = x0.clone().requires_grad_(True)
        route += torch.autograd.grad(out(x).square().sum(), [x, *params])
        x = x0.clone().requires_grad_(True)
        (gx,) = torch.autograd.grad(out(x).sum(), x, create_graph=True)
        route += torch.autograd.grad(gx.square().sum(), params, allow_unused=True)
    assert masks == [[True, True, True], [True, True, True], [False, True, False]]
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    assert got[4] is None and want[4] is None
    rel = ((got[3].double() - want[3].double()).norm() / want[3].double().norm()).item()
    assert rel <= SECOND_ORDER_TOL[F32], rel


def test_first_order_in_the_input_alone_forms_no_weight_gradient(monkeypatch):
    """``autograd.grad`` in the input without ``create_graph`` (the
    backward runs ``_backward`` itself, no ``_Conv2dGrad``) asks for the
    input gradient alone, and the result equals ``F.conv2d``'s."""
    masks = []
    backward = conv_ops._backward

    def spy(gy, x, w, stride, padding, mask):
        masks.append(list(mask))
        return backward(gy, x, w, stride, padding, mask)

    monkeypatch.setattr(conv_ops, "_backward", spy)
    layer = layers.Conv2d(16, 32, 4, 2, 1, dtype=BF16)
    x = _cl((2, 16, 8, 8), dtype=F32).requires_grad_(True)
    (got,) = torch.autograd.grad(layer(x).float().sum(), x)
    assert masks == [[True, False, False]]
    w, b = layer.weight.to(BF16, memory_format=CL), layer.bias.to(BF16)
    (want,) = torch.autograd.grad(F.conv2d(x.to(BF16), w, b, 2, 1).float().sum(), x)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["no_grad", "nothing_requires_grad"])
def test_a_call_autograd_does_not_record_is_f_conv2d_itself(case):
    """Where autograd records nothing (under ``no_grad``, as the critic
    loop's generator forwards run, or with no operand requiring grad),
    ``conv2d`` is ``F.conv2d``: no Function, equal bits."""
    x, w = _cl((2, 16, 8, 8)), _cl((32, 16, 3, 3), seed=1)
    b = torch.randn(32, generator=torch.Generator().manual_seed(2)).to(BF16)
    if case == "no_grad":
        w.requires_grad_(True)
        with torch.no_grad():
            y = conv_ops.conv2d(x, w, b, stride=1, padding=1)
    else:
        y = conv_ops.conv2d(x, w, b, stride=1, padding=1)
    assert y.grad_fn is None
    assert torch.equal(y, F.conv2d(x, w.detach(), b, 1, 1))


# every convolution shape of G2, D2 and D1 at the configurations' widths:
# (C_in, C_out, (k, s, p), bias), the 3-channel stems first, then G2's
# DownBlock and residual convs, the critics' DownBlocks and their heads
NET_CONVS = [
    (3, 128, (4, 2, 1), True), (3, 16, (4, 2, 1), True), (3, 64, (4, 2, 1), True),
    (128, 512, (4, 2, 1), False), (640, 320, (3, 1, 1), False), (320, 320, (3, 1, 1), False),
    (320, 640, (3, 1, 1), False), (16, 32, (4, 2, 1), False), (32, 64, (4, 2, 1), False),
    (64, 128, (4, 2, 1), False), (128, 256, (4, 2, 1), False), (256, 512, (4, 2, 1), False),
    (640, 160, (1, 1, 0), True), (640, 128, (1, 1, 0), True),
]


@pytest.mark.parametrize("conv", NET_CONVS, ids=[f"{c[0]}to{c[1]}k{c[2][0]}s{c[2][1]}" for c in NET_CONVS])
def test_function_at_the_nets_widths(conv):
    """At each of the nets' convolution shapes (batch 2, an 8 x 8 map, 4 x 4
    for the 1x1 heads): forward and backward in bf16 channels-last equal
    ``F.conv2d``'s bit for bit, and the penalty-shaped second order in f32
    lies within ``SECOND_ORDER_TOL`` of aten's."""
    c_in, c_out, geometry, bias = conv
    shape = (2, c_in, 4, 4) if geometry[0] == 1 else (2, c_in, 8, 8)
    got = _first_and_second_order(conv_ops.conv2d, shape, c_out, geometry, BF16, "channels_last", bias, False)
    want = _first_and_second_order(_plain, shape, c_out, geometry, BF16, "channels_last", bias, False)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    got = _first_and_second_order(conv_ops.conv2d, shape, c_out, geometry, F32, "channels_last", bias, True)
    want = _first_and_second_order(_plain, shape, c_out, geometry, F32, "channels_last", bias, True)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            rel = ((a.double() - b.double()).norm() / b.double().norm()).item()
            assert rel <= SECOND_ORDER_TOL[F32], rel
