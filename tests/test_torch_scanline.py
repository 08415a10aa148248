"""The port's scanline lerp and two-pass warps against the JAX package on
the CPU, on inputs from a numpy seed. On a CPU tensor ``scanline_lerp``
runs its plain version; the JAX side runs its Pallas kernel in interpret
mode.

Tolerances: the forward is two gathers and a lerp in f32 on both sides:
rtol = atol = 1e-6. The backward rounds the tent weights and the
cotangent to bf16 on both sides in the same places: rtol = atol = 1e-5
against ``jax.vjp`` (f32 sums in another order), and 2e-2 against
autograd through an f32 dense tent product (the bf16 rounding itself).
The dense warp and ``resize_axis_aligned`` round weights and pixels to
bf16 and sum in f32 on both sides: 1e-5 (a position that rounds across a
bf16 step on one side would show as 4e-3; none does at these seeds). The
two warp forms against each other: the JAX package's own test's
tolerances (atol 2e-2 values; rtol 2e-2, atol 4e-2 gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagegenerator_tpu.ops.pallas import scanline_lerp as jsl
from imagegenerator_tpu.v2 import warp2pass as jw
from imagegenerator_tpu.v2.augment import affine_homography, perspective_homography
from imagegenerator_tpu_torch.ops.kernels import scanline_lerp as tsl
from imagegenerator_tpu_torch.v2 import warp2pass as tw


def _coords(rng, S, O, K, decreasing=False, wild=False):
    if wild:
        return rng.uniform(-5.0, K + 5.0, (S, O)).astype(np.float32)
    steps = rng.uniform(0.35, 0.9, (S, O)) * (K / O) * 1.6
    coords = (np.cumsum(steps, axis=1) - 2.0).astype(np.float32)
    return np.ascontiguousarray(coords[:, ::-1]) if decreasing else coords


@pytest.mark.parametrize("S,C,K,O,kind", [
    (6, 3, 32, 48, "increasing"), (6, 3, 32, 48, "decreasing"), (5, 3, 24, 24, "wild"),
    (4, 1, 2, 7, "increasing"), (3, 3, 128, 224, "increasing"),
])
def test_forward_matches_pallas_interpret(S, C, K, O, kind):
    rng = np.random.default_rng(S * K + O)
    src = rng.uniform(size=(S, C, K)).astype(np.float32)
    coords = _coords(rng, S, O, K, kind == "decreasing", kind == "wild")
    got = tsl.scanline_lerp(torch.from_numpy(src), torch.from_numpy(coords))
    want = jsl.scanline_lerp(jnp.asarray(src), jnp.asarray(coords), True)
    assert got.shape == (S, C, O) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_forward_beyond_the_tpu_kernels_width_matches_the_tent_product():
    """K = 200: past the JAX kernel's one-register limit (it asserts), so
    the oracle is the dense tent product in f64."""
    rng = np.random.default_rng(3)
    S, C, K, O = 4, 3, 200, 224
    src = rng.uniform(size=(S, C, K))
    coords = _coords(rng, S, O, K)
    with pytest.raises(AssertionError):
        jsl.scanline_lerp(jnp.asarray(src, jnp.float32), jnp.asarray(coords), True)
    s = np.clip(coords.astype(np.float64), 0.0, K - 1.0)
    w = np.maximum(0.0, 1.0 - np.abs(s[..., None] - np.arange(K)))
    want = np.einsum("sok,sck->sco", w, src)
    got = tsl.scanline_lerp(torch.from_numpy(src.astype(np.float32)), torch.from_numpy(coords))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_four_d_strided_source_is_the_same_function():
    rng = np.random.default_rng(4)
    N, H, W, C, O = 2, 6, 8, 3, 10
    img = torch.from_numpy(rng.uniform(size=(N, H, W, C)).astype(np.float32))
    coords = torch.from_numpy(_coords(rng, N * H, O, W))
    view = img.permute(0, 1, 3, 2)  # (N, H, C, W), no copy
    got = tsl.scanline_lerp(view, coords)
    want = tsl.scanline_lerp(view.reshape(N * H, C, W).contiguous(), coords)
    assert got.shape == (N, H, C, O) and got.is_contiguous()
    assert torch.equal(got.reshape(N * H, C, O), want)


@pytest.mark.parametrize("kind", ["increasing", "wild"])
def test_backward_matches_jax_vjp(kind):
    rng = np.random.default_rng(11)
    S, C, K, O = 4, 3, 24, 40
    src = rng.uniform(size=(S, C, K)).astype(np.float32)
    coords = _coords(rng, S, O, K, wild=kind == "wild")
    cot = rng.normal(size=(S, C, O)).astype(np.float32)
    leaf = torch.from_numpy(src).requires_grad_(True)
    tc = torch.from_numpy(coords).requires_grad_(True)
    tsl.scanline_lerp(leaf, tc).backward(torch.from_numpy(cot))
    _, vjp = jax.vjp(lambda a: jsl.scanline_lerp(a, jnp.asarray(coords), True), jnp.asarray(src))
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]), rtol=1e-5, atol=1e-5)
    assert tc.grad is None  # coords get no gradient
    # and against autograd through the f32 dense tent product
    dense_leaf = torch.from_numpy(src).requires_grad_(True)
    dense = torch.einsum("sok,sck->sco", tsl.tent_weights(torch.from_numpy(coords), K), dense_leaf)
    dense.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(leaf.grad.numpy(), dense_leaf.grad.numpy(), rtol=2e-2, atol=2e-2)


def test_wrapper_refuses_bad_shapes():
    with pytest.raises(ValueError, match="K=1"):
        tsl.scanline_lerp(torch.zeros((2, 3, 1)), torch.zeros((2, 4)))
    with pytest.raises(ValueError, match="coords"):
        tsl.scanline_lerp(torch.zeros((2, 3, 8)), torch.zeros((3, 4)))
    with pytest.raises(ValueError, match="3-D or 4-D"):
        tsl.scanline_lerp(torch.zeros((3, 8)), torch.zeros((3, 4)))
    with pytest.raises(ValueError, match="device"):
        tsl.scanline_lerp_fwd(torch.zeros((1, 2, 3, 8), device="meta"), torch.zeros((2, 4), device="meta"))


def _smooth(rng, n, h, w):
    small = rng.uniform(size=(n, h // 4, w // 4, 3)).astype(np.float32)
    return np.asarray(jax.image.resize(jnp.asarray(small), (n, h, w, 3), method="cubic"))


def _homographies(H, W, Ho, Wo):
    s = H / float(Ho)
    crop = jnp.array([[s, 0.0, 1.0 + (s - 1) / 2], [0.0, s, 0.5 + (s - 1) / 2], [0.0, 0.0, 1.0]])
    rot = affine_homography(Ho, Wo, jnp.asarray(12.0), jnp.array([0.6, -0.9]))
    corners = jnp.array([[1.0, 1.5], [0.5, Wo - 2.0], [Ho - 1.5, Wo - 1.0], [Ho - 1.0, 0.5]])
    persp = perspective_homography(Ho, Wo, corners)
    flip = jnp.array([[1.0, 0.0, 0.0], [0.0, -1.0, Wo - 1.0], [0.0, 0.0, 1.0]])
    return np.asarray(jnp.stack([crop @ rot, crop @ persp, crop @ flip @ rot @ persp, crop]))


def _warp_pair(imgs, Ms, out_shape, kernel, monkeypatch):
    """(values, image gradient of sum(out ** 2)) from the port and from
    the JAX package, both through the kernel path or both dense."""
    monkeypatch.setenv("IMAGEGEN_WARP_KERNEL", "1" if kernel else "0")
    leaf = torch.from_numpy(imgs).requires_grad_(True)
    out = tw.warp_homography_2pass(leaf, torch.from_numpy(Ms), out_shape, warp_kernel=kernel)
    (out ** 2).sum().backward()

    def f(im):
        return jw.warp_homography_2pass(im, jnp.asarray(Ms), out_shape=out_shape)

    want = f(jnp.asarray(imgs))
    want_g = jax.grad(lambda im: jnp.sum(f(im) ** 2))(jnp.asarray(imgs))
    return (out.detach().numpy(), leaf.grad.numpy()), (np.asarray(want), np.asarray(want_g))


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel_path", "dense"])
def test_warp_homography_2pass_matches_jax(kernel, monkeypatch):
    rng = np.random.default_rng(5)
    H = W = 16
    Ho = Wo = 24
    imgs = _smooth(rng, 4, H, W)
    got, want = _warp_pair(imgs, _homographies(H, W, Ho, Wo), (Ho, Wo), kernel, monkeypatch)
    assert got[0].shape == (4, Ho, Wo, 3)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    # the gradient sums 2 * out * weight over outputs; out is O(1)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-4)


def test_warp_kernel_path_against_the_dense_form(monkeypatch):
    """The port's two forms against each other at the JAX test's own
    tolerances; the environment variable alone selects the form when the
    argument is None."""
    rng = np.random.default_rng(6)
    imgs = torch.from_numpy(_smooth(rng, 4, 16, 16))
    Ms = torch.from_numpy(_homographies(16, 16, 24, 24))
    outs = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("IMAGEGEN_WARP_KERNEL", flag)
        assert tw.use_warp_kernel(None) is (flag == "1")
        leaf = imgs.clone().requires_grad_(True)
        out = tw.warp_homography_2pass(leaf, Ms, (24, 24))
        (out ** 2).sum().backward()
        outs[flag] = (out.detach().numpy(), leaf.grad.numpy())
    np.testing.assert_allclose(outs["1"][0], outs["0"][0], atol=2e-2)
    np.testing.assert_allclose(outs["1"][1], outs["0"][1], rtol=2e-2, atol=4e-2)
    eye = torch.eye(3)[None].expand(4, 3, 3)
    same = tw.warp_homography_2pass(imgs, eye, warp_kernel=True)
    np.testing.assert_allclose(same.numpy(), imgs.numpy(), atol=1e-5)


def test_resize_axis_aligned_matches_jax():
    rng = np.random.default_rng(8)
    N, H, W = 3, 16, 12
    imgs = _smooth(rng, N, H, W)
    scale = rng.uniform(0.3, 0.9, (N, 2)).astype(np.float32)
    offset = rng.uniform(-1.0, 3.0, (N, 2)).astype(np.float32)
    leaf = torch.from_numpy(imgs).requires_grad_(True)
    out = tw.resize_axis_aligned(leaf, torch.from_numpy(scale), torch.from_numpy(offset), (20, 24))
    (out ** 2).sum().backward()

    def f(im):
        return jw.resize_axis_aligned(im, jnp.asarray(scale), jnp.asarray(offset), (20, 24))

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(f(jnp.asarray(imgs))), rtol=1e-5, atol=1e-5)
    want_g = jax.grad(lambda im: jnp.sum(f(im) ** 2))(jnp.asarray(imgs))
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want_g), rtol=2e-2, atol=2e-2)


def test_scanline_coords_match_jax():
    Ms = _homographies(16, 16, 24, 20)
    hx, sy = tw._homography_scanline_coords(torch.from_numpy(Ms), 16, 24, 20)
    jhx, jsy = jw._homography_scanline_coords(jnp.asarray(Ms), 16, 24, 20)
    np.testing.assert_allclose(hx.numpy(), np.asarray(jhx), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(sy.numpy(), np.asarray(jsy), rtol=1e-5, atol=1e-4)
