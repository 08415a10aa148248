"""The port's bindings to the C++ host ops (``data/native.py``) and the
loader's use of them (``data/coco.py``) against the JAX package's
``data/native.py`` and ``data/coco.py``: both compile
``native/host_ops.cpp`` with the same flags, so every entry point and both
decode routes (a JPEG through libjpeg; a PNG through Pillow, then the
host ops' resample) give bit-equal outputs. The port's build lands under
``build/native/``; a build without libjpeg sends JPEGs to Pillow, and the
loader says so."""

import io

import numpy as np
import pytest
from PIL import Image

from imagegenerator_tpu.data import coco as jcoco
from imagegenerator_tpu.data import native as jnative
from imagegenerator_tpu_torch.data import coco, native

ROOT = native.SRC.parents[1]


def _photo(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    chans = [np.sin(x / (7.0 + c)) * 70 + np.cos(y / (4.0 + 2 * c)) * 50 + 128 + rng.integers(-15, 16, (h, w))
             for c in range(3)]
    return np.stack(chans, axis=2).clip(0, 255).astype(np.uint8)


def _encode(arr, fmt):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt, **({"quality": 90} if fmt == "JPEG" else {}))
    return buf.getvalue()


@pytest.fixture(scope="module")
def both():
    if not (native.available() and jnative.available()):
        pytest.fail("g++ could not build native/host_ops.cpp for one of the packages")
    return native.get_lib(), jnative.get_lib()


def test_the_build_lands_under_build(both):
    path = native.library_path(native.jpeg())
    assert path.is_file() and path.parent.parent == ROOT / "build" / "native"
    assert path.parent != native.SRC.parent
    assert native.jpeg() == (jnative.decode_jpeg_resize_u8(_encode(_photo(16, 16, 0), "JPEG"), 8) is not None)


@pytest.mark.parametrize("fast_dct", ["1", "0"])
@pytest.mark.parametrize("fmt,shape,size", [("JPEG", (480, 640), 64), ("JPEG", (300, 260), 256),
                                            ("PNG", (480, 640), 64), ("PNG", (37, 53), 16)])
def test_decode_routes_are_bit_equal_to_jax(both, monkeypatch, fmt, shape, size, fast_dct):
    monkeypatch.setenv("IMAGEGEN_FAST_DCT", fast_dct)
    data = _encode(_photo(*shape, seed=size), fmt)
    for ours, theirs in ((coco.decode_resize_u8, jcoco.decode_resize_u8),
                         (coco.decode_resize_normalize, jcoco.decode_resize_normalize)):
        got, want = ours(data, size), theirs(data, size)
        assert got.dtype == want.dtype and got.shape == (size, size, 3)
        np.testing.assert_array_equal(got, want)


def test_entry_points_are_bit_equal_to_jax(both):
    imgs = [_photo(40 + 9 * i, 64 - 7 * i, seed=i) for i in range(3)]
    jpeg = _encode(imgs[0], "JPEG")
    for fast in (False, True):
        for ours, theirs in ((native.decode_jpeg_resize_u8, jnative.decode_jpeg_resize_u8),
                             (native.decode_jpeg_resize_normalize, jnative.decode_jpeg_resize_normalize)):
            np.testing.assert_array_equal(ours(jpeg, 24, fast_dct=fast), theirs(jpeg, 24, fast_dct=fast))
    assert native.decode_jpeg_resize_u8(b"\xff\xd8 not a jpeg", 8) is None
    for im in imgs:
        np.testing.assert_array_equal(native.resize_u8(im, 20), jnative.resize_u8(im, 20))
        np.testing.assert_array_equal(native.resize_normalize(im, 20), jnative.resize_normalize(im, 20))
    np.testing.assert_array_equal(native.batch_resize_normalize(imgs, 12, num_threads=2),
                                  jnative.batch_resize_normalize(imgs, 12, num_threads=2))
    # within one gray level of Pillow's BILINEAR
    pil = np.asarray(Image.fromarray(imgs[1]).resize((20, 20), Image.BILINEAR), np.int64)
    assert np.abs(native.resize_u8(imgs[1], 20).astype(np.int64) - pil).max() <= 1
    with pytest.raises(ValueError, match="channel count"):
        native.batch_resize_normalize([imgs[0], imgs[1][..., :1]], 8)


def test_a_build_without_libjpeg_sends_jpegs_to_pillow(both, monkeypatch, capsys):
    """The second build of the two-step build: ``-DHOST_OPS_NO_JPEG``.
    JPEGs then take Pillow's decode and the host ops' resample, which is
    what the JAX package does without its JPEG entry point."""
    build = native._build
    monkeypatch.setattr(native, "_build", lambda with_jpeg: None if with_jpeg else build(False))
    native._load.cache_clear()
    try:
        assert native.available() and not native.jpeg()
        assert native.library_path(False).is_file()
        data = _encode(_photo(120, 90, seed=4), "JPEG")
        assert native.decode_jpeg_resize_u8(data, 16) is None
        monkeypatch.setattr(jnative, "decode_jpeg_resize_u8", lambda *a, **k: None)
        np.testing.assert_array_equal(coco.decode_resize_u8(data, 16), jcoco.decode_resize_u8(data, 16))
        assert coco.describe_routes().startswith("decoded by Pillow; resampled by the C++ host ops")
    finally:
        monkeypatch.setattr(native, "_build", build)
        native._load.cache_clear()
    assert native.jpeg() == native.library_path(True).is_file()


def test_the_loader_says_which_routes_it_takes(both, monkeypatch):
    said = coco.describe_routes()
    assert "resampled by the C++ host ops' antialiased triangle filter" in said
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(native, "jpeg", lambda: False)
    assert coco.describe_routes() == "decoded by Pillow; resampled by Pillow's resize(BILINEAR) (no C++ host ops)"
    monkeypatch.setattr(coco, "_pillow", lambda: None)
    assert "standard-library PNG reader" in coco.describe_routes()
    assert "torch's antialiased bilinear" in coco.describe_routes()
