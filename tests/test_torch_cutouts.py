"""The port's cutout sampler and augmentations against the JAX package on
the CPU. JAX's threefry draws cannot come from a ``torch.Generator``, so
``jax_draws`` rebuilds every draw of one ``MakeCutouts`` call from JAX's
key tree and the port replays them (``MakeCutouts.apply``); inputs come
from a numpy seed.

Tolerances: the colour and geometry functions are elementwise f32 on
both sides: 1e-5 (hue wraps mod 1, so hues are compared on the circle).
The cutouts run the dense warp and the axis-aligned resize, both with
bf16-rounded weights and pixels and f32 sums: 1e-4 on values in [0, 1]
with at most one output in 1,000 off by up to one bf16 step of a weight
or pixel (8e-3), where a weight lands on the other side of a rounding
boundary; the scanline-kernel warp is f32 and held to 1e-4 as well.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagegenerator_tpu.v2 import augment as jaug
from imagegenerator_tpu.v2 import cutouts as jcut
from imagegenerator_tpu_torch.v2 import augment as taug
from imagegenerator_tpu_torch.v2 import cutouts as tcut


def _t(a):
    return torch.from_numpy(np.array(a))


def jax_draws(key, cutn, B, cut_size, C=3, noise_fac=0.1, hue=0.01, sat=0.01, sharp=0.3,
              degrees=30.0, translate=0.1):
    """Every draw of ``imagegenerator_tpu.v2.cutouts.MakeCutouts.__call__``
    (fast path) for ``key``, as the port's ``MakeCutouts.draw`` lays them
    out: the key tree of ``cutouts.py`` and of ``random_color_augment``
    and ``random_geometry``."""
    N = B * cutn
    k_size, k_off, k_aug, k_noise, k_nfac = jax.random.split(key, 5)
    ck = jax.random.split(k_aug, 5)
    gk = jax.random.split(jax.random.fold_in(k_aug, 1), 5)
    draws = {
        "u": jax.random.uniform(k_size, (cutn,)),
        "offs": jax.random.uniform(k_off, (cutn, 2)),
        "color": {
            "do_jit": jax.random.bernoulli(ck[0], 0.7, (N,)),
            "hue_shift": jax.random.uniform(ck[1], (N,), minval=-hue, maxval=hue),
            "sat_fac": jax.random.uniform(ck[2], (N,), minval=1 - sat, maxval=1 + sat),
            "do_sharp": jax.random.bernoulli(ck[3], 0.4, (N,)),
            "sharp_fac": jax.random.uniform(ck[4], (N,), minval=1.0, maxval=1.0 + sharp),
        },
        "geometry": {
            "do_flip": jax.random.bernoulli(gk[0], 0.5, (N,)),
            "do_aff": jax.random.bernoulli(gk[1], 0.8, (N,)),
            "angles": jax.random.uniform(gk[2], (N,), minval=-degrees, maxval=degrees),
            "trans": jax.random.uniform(gk[3], (N, 2), minval=-translate, maxval=translate)
            * jnp.array([cut_size, cut_size]),
            "do_persp": jax.random.bernoulli(gk[4], 0.4, (N,)),
            "corner_u": jax.random.uniform(jax.random.fold_in(gk[4], 1), (N, 4, 2)),
        },
        "facs": jax.random.uniform(k_nfac, (N, 1, 1, 1), maxval=noise_fac),
        "noise": jax.random.normal(k_noise, (N, cut_size, cut_size, C)),
    }
    return jax.tree.map(_t, draws)


def _images(rng, n, h, w):
    small = rng.uniform(size=(n, h // 4, w // 4, 3)).astype(np.float32)
    return np.clip(np.asarray(jax.image.resize(jnp.asarray(small), (n, h, w, 3), method="cubic")), 0, 1)


# ----------------------------------------------------------------- colour
def test_hsv_round_trip_and_match():
    rng = np.random.default_rng(0)
    rgb = rng.uniform(size=(3, 6, 5, 3)).astype(np.float32)
    rgb[0, 0, 0] = [0.5, 0.5, 0.5]  # grey: no hue
    rgb[0, 0, 1] = [0.0, 0.0, 0.0]
    rgb[0, 0, 2] = [1.0, 0.2, 0.2]
    hsv = taug.rgb_to_hsv(_t(rgb))
    want = np.asarray(jaug.rgb_to_hsv(jnp.asarray(rgb)))
    dh = np.abs(hsv[..., 0].numpy() - want[..., 0])
    assert np.minimum(dh, 1 - dh).max() <= 1e-5
    np.testing.assert_allclose(hsv[..., 1:].numpy(), want[..., 1:], rtol=1e-5, atol=1e-5)
    back = taug.hsv_to_rgb(_t(want))
    np.testing.assert_allclose(back.numpy(), np.asarray(jaug.hsv_to_rgb(jnp.asarray(want))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(back.numpy(), rgb, atol=1e-5)


def test_color_jitter_and_sharpness_match_jax():
    rng = np.random.default_rng(1)
    imgs = rng.uniform(-0.1, 1.1, (4, 8, 9, 3)).astype(np.float32)
    hue = rng.uniform(-0.05, 0.05, 4).astype(np.float32)
    sat = rng.uniform(0.5, 1.5, 4).astype(np.float32)
    got = taug.color_jitter(_t(imgs), _t(hue), _t(sat))
    want = jax.vmap(jaug.color_jitter)(jnp.asarray(imgs), jnp.asarray(hue), jnp.asarray(sat))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    fac = rng.uniform(1.0, 1.3, 4).astype(np.float32)
    imgs = np.clip(imgs, 0, 1)
    got = taug.sharpness(_t(imgs), _t(fac))
    want = jax.vmap(jaug.sharpness)(jnp.asarray(imgs), jnp.asarray(fac))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # the 1-px border stays as it is; one image with a scalar factor too
    assert torch.equal(got[:, 0], _t(imgs)[:, 0]) and torch.equal(got[:, :, -1], _t(imgs)[:, :, -1])
    one = taug.sharpness(_t(imgs[0]), 1.2)
    np.testing.assert_allclose(one.numpy(), np.asarray(jaug.sharpness(jnp.asarray(imgs[0]), 1.2)), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------- geometry
def test_homographies_match_jax():
    rng = np.random.default_rng(2)
    H, W, n = 24, 20, 5
    angles = rng.uniform(-30, 30, n).astype(np.float32)
    trans = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    got = taug.affine_homography(H, W, _t(angles), _t(trans))
    want = jax.vmap(lambda a, t: jaug.affine_homography(H, W, a, t))(jnp.asarray(angles), jnp.asarray(trans))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    base = np.array([[0.0, 0.0], [0.0, W - 1.0], [H - 1.0, W - 1.0], [H - 1.0, 0.0]], np.float32)
    corners = base + rng.uniform(-2, 2, (n, 4, 2)).astype(np.float32)
    got = taug.perspective_homography(H, W, _t(corners))
    want = jax.vmap(lambda c: jaug.perspective_homography(H, W, c))(jnp.asarray(corners))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    # the output rectangle's corners land on the asked source corners
    pts = np.concatenate([base, np.ones((4, 1), np.float32)], axis=1)
    mapped = np.einsum("nij,cj->nci", got.numpy(), pts)
    np.testing.assert_allclose(mapped[..., :2] / mapped[..., 2:], corners, atol=1e-3)


@pytest.mark.parametrize("seed", [0, 1])
def test_random_color_augment_and_geometry_match_jax_with_its_draws(seed):
    key = jax.random.key(seed)
    cutn, B, cs = 6, 2, 24
    draws = jax_draws(key, cutn, B, cs)
    k_aug = jax.random.split(key, 5)[2]
    batch = _images(np.random.default_rng(seed), B * cutn, 12, 12)
    got = taug.random_color_augment(draws["color"], _t(batch))
    want = jaug.random_color_augment(k_aug, jnp.asarray(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    got = taug.random_geometry(draws["geometry"], cs, cs)
    want = jaug.random_geometry(jax.random.fold_in(k_aug, 1), B * cutn, cs, cs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- cutouts
def _mostly_close(got, want, tol=1e-4, step=8e-3, share=1e-3):
    err = np.abs(got - want)
    assert err.max() <= step, err.max()
    assert (err > tol).mean() <= share, (err > tol).mean()


@pytest.mark.parametrize("split,kernel", [(True, False), (False, False), (True, True), (False, True)],
                         ids=["split-dense", "composed-dense", "split-kernel", "composed-kernel"])
def test_make_cutouts_matches_jax_with_its_draws(split, kernel, monkeypatch):
    monkeypatch.setenv("IMAGEGEN_WARP_KERNEL", "1" if kernel else "0")
    key = jax.random.key(3)
    cutn, B, cs, H, W = 5, 2, 24, 16, 16
    images = _images(np.random.default_rng(3), B, H, W)
    port = tcut.MakeCutouts(cut_size=cs, cutn=cutn, warp_split=split, warp_kernel=kernel)
    got = port.apply(jax_draws(key, cutn, B, cs), _t(images))
    want = jcut.MakeCutouts(cut_size=cs, cutn=cutn, warp_split=split)(key, jnp.asarray(images))
    assert got.shape == (B * cutn, cs, cs, 3)
    _mostly_close(got.numpy(), np.asarray(want))


def test_make_cutouts_gradient_matches_jax():
    key = jax.random.key(4)
    cutn, B, cs = 4, 1, 24
    images = _images(np.random.default_rng(4), B, 16, 16)
    cot = np.random.default_rng(5).normal(size=(B * cutn, cs, cs, 3)).astype(np.float32)
    leaf = _t(images).requires_grad_(True)
    tcut.MakeCutouts(cut_size=cs, cutn=cutn, warp_kernel=False).apply(
        jax_draws(key, cutn, B, cs), leaf).backward(_t(cot))
    _, vjp = jax.vjp(lambda im: jcut.MakeCutouts(cut_size=cs, cutn=cutn)(key, im), jnp.asarray(images))
    want = np.asarray(vjp(jnp.asarray(cot))[0])
    # each pixel sums ~ cutn * (24 / 16) ** 2 weighted cotangents, with
    # bf16 roundings of the cotangent on the way: 2e-2 of the largest
    assert np.abs(leaf.grad.numpy() - want).max() <= 2e-2 * np.abs(want).max()


def test_draw_shapes_ranges_and_replay():
    port = tcut.MakeCutouts(cut_size=24, cutn=5)
    gen = torch.Generator().manual_seed(0)
    draws = port.draw(gen, (2, 16, 16, 3))
    again = port.draw(torch.Generator().manual_seed(0), (2, 16, 16, 3))
    want = jax_draws(jax.random.key(0), 5, 2, 24)
    flat, flat_again, flat_want = (jax.tree.leaves(d) for d in (draws, again, want))
    assert jax.tree.structure(draws) == jax.tree.structure(want)
    for a, b, w in zip(flat, flat_again, flat_want):
        assert a.shape == w.shape and a.dtype == w.dtype
        assert torch.equal(a, b)
    assert float(draws["facs"].max()) < 0.1 and float(draws["facs"].min()) >= 0.0
    assert float(draws["geometry"]["trans"].abs().max()) <= 2.4
    images = _t(_images(np.random.default_rng(6), 2, 16, 16))
    assert torch.equal(port.apply(draws, images), port(torch.Generator().manual_seed(0), images))
    quiet = tcut.MakeCutouts(cut_size=24, cutn=5, noise_fac=0.0)
    assert "noise" not in quiet.draw(gen, (2, 16, 16, 3))
    assert float(quiet(gen, images).max()) <= 1.0


@pytest.mark.parametrize("kw,shape", [({}, (1, 32, 32, 3)), ({"force_lanczos": True}, (1, 16, 16, 3)),
                                      ({"augment": False}, (1, 16, 16, 3))])
def test_lanczos_path_is_not_ported(kw, shape):
    port = tcut.MakeCutouts(cut_size=24, cutn=2, **kw)
    with pytest.raises(NotImplementedError, match="lanczos"):
        port(torch.Generator().manual_seed(0), torch.zeros(shape))
