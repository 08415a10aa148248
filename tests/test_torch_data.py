"""The port's data path against the JAX package's on the same blobs:
the stores, ``build_manifest``, ``CocoCaptions`` and the loader's host
batches (equal, on the Pillow route both packages share); the standard
library PNG reader against ``utils/png.py``'s writer and Pillow's decode
(equal, on gray / RGB / RGBA and every filter type); the route without
Pillow: ``F.interpolate(bilinear, antialias)`` within 1 gray level of
``Image.resize(BILINEAR)``, and a named ``ImportError`` for what the
reader does not take."""

import io
import json
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from imagegenerator_tpu import data as jdata
from imagegenerator_tpu.data import native as jnative
from imagegenerator_tpu_torch.data import coco, storage
from imagegenerator_tpu_torch.data import native as tnative
from imagegenerator_tpu_torch.data.pipeline import DataLoader
from imagegenerator_tpu_torch.data.tokenizer import HashTokenizer
from imagegenerator_tpu_torch.utils import png

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def jax_pillow_route(monkeypatch):
    """Both packages decode with Pillow, not with their C++ host ops
    (which agree with Pillow to about 1/255 only;
    ``tests/test_torch_native.py`` holds the two packages' host-ops
    routes to each other)."""
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "jpeg", lambda: False)


def _png(arr) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _fill(stores, n=6, seed=0):
    """The same COCO-style blobs into every store: ``n`` RGB PNGs of
    unequal sizes, two captions each, one annotation without an image."""
    rng = np.random.default_rng(seed)
    images, anns = [], []
    blobs = {}
    for i in range(n):
        arr = rng.integers(0, 256, (40 + 7 * i, 64 - 5 * i, 3), dtype=np.uint8)
        blobs[f"imgs/img{i}.png"] = _png(arr)
        images.append({"id": i, "file_name": f"img{i}.png"})
        anns += [{"image_id": i, "caption": f"caption {i}, first"},
                 {"image_id": i, "caption": f"another caption of image {i}"}]
    anns.append({"image_id": 99, "caption": "an orphan"})
    blobs["ann/captions.json"] = json.dumps({"images": images, "annotations": anns}).encode()
    for s in stores:
        for path, data in blobs.items():
            s.write_bytes(path, data)
    return blobs


def test_stores_match_jax(tmp_path):
    pairs = [(storage.MemoryStore(), jdata.MemoryStore()),
             (storage.LocalStore(str(tmp_path / "a")), jdata.LocalStore(str(tmp_path / "b")))]
    for ours, theirs in pairs:
        blobs = _fill([ours, theirs])
        for path, data in blobs.items():
            assert ours.read_bytes(path) == theirs.read_bytes(path) == data
            assert ours.exists(path) and theirs.exists(path)
        assert ours.read_text("ann/captions.json") == theirs.read_text("ann/captions.json")
        assert not ours.exists("imgs/none.png") and not theirs.exists("imgs/none.png")
        for prefix in ("imgs", "imgs/", "", "ann", "nowhere"):
            assert ours.listdir(prefix) == theirs.listdir(prefix), prefix
        ours.write_text("notes/x.txt", "héllo")
        assert ours.read_text("notes/x.txt") == "héllo"
        with pytest.raises(FileNotFoundError):
            ours.read_bytes("imgs/none.png")
    assert not list((tmp_path / "a").rglob("*.tmp"))
    assert storage.open_store("mem://torch-data-test") is storage.open_store("mem://torch-data-test")
    assert isinstance(storage.open_store(str(tmp_path)), storage.LocalStore)


@pytest.mark.parametrize("image_dtype", ["uint8", "float32"])
def test_manifest_and_dataset_match_jax(image_dtype):
    ours, theirs = storage.MemoryStore(), jdata.MemoryStore()
    _fill([ours, theirs])
    got, want = coco.build_manifest(ours, "ann/captions.json"), jdata.build_manifest(theirs, "ann/captions.json")
    assert [(e.caption, e.file_name) for e in got] == [(e.caption, e.file_name) for e in want]
    assert len(got) == 12
    for host_index, host_count in ((0, 1), (0, 5), (4, 5)):
        kw = dict(image_size=16, host_index=host_index, host_count=host_count, image_dtype=image_dtype)
        a = coco.CocoCaptions(ours, "imgs/", "ann/captions.json", **kw)
        b = jdata.CocoCaptions(theirs, "imgs/", "ann/captions.json", **kw)
        assert len(a) == len(b) == 12 // host_count
        for i in range(len(a)):
            (cap_a, img_a), (cap_b, img_b) = a[i], b[i]
            assert cap_a == cap_b
            assert img_a.dtype == img_b.dtype == np.dtype(image_dtype) and img_a.shape == (16, 16, 3)
            np.testing.assert_array_equal(img_a, img_b)
    with pytest.raises(ValueError, match="image_dtype"):
        coco.CocoCaptions(ours, "imgs", "ann/captions.json", image_dtype="float16")


@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_host_batches_match_jax(shuffle):
    ours, theirs = storage.MemoryStore(), jdata.MemoryStore()
    _fill([ours, theirs])
    tok = HashTokenizer(vocab_size=128, max_length=8)
    jtok = jdata.HashTokenizer(vocab_size=128, max_length=8)
    a = DataLoader(coco.CocoCaptions(ours, "imgs", "ann/captions.json", image_size=16), tok, 5,
                   shuffle=shuffle, seed=3, num_workers=2, host_prefetch=2, device="cpu")
    b = jdata.DataLoader(jdata.CocoCaptions(theirs, "imgs", "ann/captions.json", image_size=16), jtok, 5,
                         shuffle=shuffle, seed=3, num_workers=2, host_prefetch=2)
    assert len(a) == len(b) == 2
    seen = []
    for epoch in (1, 2):
        a.epoch = b.epoch = epoch
        np.testing.assert_array_equal(a._epoch_indices(), b._epoch_indices())
        got, want = list(a._host_batches()), list(b._host_batches())
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert set(g) == set(w) == {"input_ids", "attention_mask", "image"}
            for k in g:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
        seen.append(np.concatenate([g["input_ids"] for g in got]))
    assert shuffle != np.array_equal(seen[0], seen[1])


def test_loader_yields_device_batches():
    store = storage.MemoryStore()
    _fill([store])
    ds = coco.CocoCaptions(store, "imgs", "ann/captions.json", image_size=16)
    loader = DataLoader(ds, HashTokenizer(128, 8), 4, seed=1, num_workers=2, device_prefetch=1, device="cpu")
    first = list(loader)
    assert loader.epoch == 1 and len(first) == len(loader) == 3
    for batch in first:
        assert batch["image"].dtype == torch.uint8 and batch["image"].shape == (4, 16, 16, 3)
        assert batch["input_ids"].dtype == batch["attention_mask"].dtype == torch.int32
        assert batch["input_ids"].shape == (4, 8) and batch["image"].device.type == "cpu"
    second = list(loader)  # another epoch, another order
    assert loader.epoch == 2
    assert not all(torch.equal(x["input_ids"], y["input_ids"]) for x, y in zip(first, second))
    again = DataLoader(ds, HashTokenizer(128, 8), 4, seed=1, num_workers=3, host_prefetch=1, device="cpu")
    for x, y in zip(first, again):
        assert all(torch.equal(x[k], y[k]) for k in x)
    f32 = DataLoader(coco.CocoCaptions(store, "imgs", "ann/captions.json", image_size=16, image_dtype="float32"),
                     HashTokenizer(128, 8), 4, seed=1, device="cpu")
    batch = next(iter(f32))
    assert batch["image"].dtype == torch.float32
    torch.testing.assert_close(batch["image"], first[0]["image"].float() / 255 * 2 - 1)
    with pytest.raises(NotImplementedError, match="drop_last"):
        DataLoader(ds, HashTokenizer(128, 8), 4, drop_last=False, device="cpu")
    if not torch.cuda.is_available():  # the card by default, and no fallback
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DataLoader(ds, HashTokenizer(128, 8), 4)


# ------------------------------------------------------ the PNG reader


def _filtered_png(arr, kind) -> bytes:
    """A PNG of ``arr`` (``(H, W)`` or ``(H, W, C)`` uint8) with every row
    under filter type ``kind``."""
    h, w = arr.shape[:2]
    bpp = 1 if arr.ndim == 2 else arr.shape[2]
    colour = {1: 0, 3: 2, 4: 6}[bpp]
    rows = arr.reshape(h, w * bpp).astype(np.int64)
    left = np.concatenate([np.zeros((h, bpp), np.int64), rows[:, :-bpp]], axis=1)
    up = np.concatenate([np.zeros((1, w * bpp), np.int64), rows[:-1]])
    upleft = np.concatenate([np.zeros((h, bpp), np.int64), up[:, :-bpp]], axis=1)
    p = left + up - upleft
    pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    pred = [np.zeros_like(rows), left, up, (left + up) // 2, paeth][kind]
    body = np.concatenate([np.full((h, 1), kind, np.uint8), ((rows - pred) % 256).astype(np.uint8)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)
    raw = zlib.compress(body.tobytes())
    half = len(raw) // 2  # two IDAT chunks
    return (b"\x89PNG\r\n\x1a\n" + png._chunk(b"IHDR", ihdr) + png._chunk(b"tEXt", b"comment\0x")
            + png._chunk(b"IDAT", raw[:half]) + png._chunk(b"IDAT", raw[half:]) + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", range(5))
@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_png_reader_equals_pillow_on_every_filter(mode, kind):
    rng = np.random.default_rng(kind)
    shape = {"L": (13, 17), "RGB": (13, 17, 3), "RGBA": (13, 17, 4)}[mode]
    arr = rng.integers(0, 256, shape, dtype=np.uint8)
    data = _filtered_png(arr, kind)
    img = Image.open(io.BytesIO(data))
    assert img.mode == mode
    want = np.asarray(img.convert("RGB"))
    if mode == "RGB":
        np.testing.assert_array_equal(want, arr)
    got = png.decode_png(data)
    assert got.dtype == np.uint8 and got.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_png_reader_reads_what_pillow_and_the_writer_write(mode):
    rng = np.random.default_rng(1)
    # smooth content, so that Pillow's encoder picks among the filters
    y, x = np.mgrid[0:48, 0:64]
    base = (np.sin(x / 9.0) * 80 + np.cos(y / 7.0) * 60 + 128 + rng.integers(0, 8, (48, 64))).clip(0, 255)
    arr = base.astype(np.uint8)
    if mode != "L":
        arr = np.stack([arr, arr[::-1], arr[:, ::-1], np.full_like(arr, 200)][:len(mode)], axis=2)
    np.testing.assert_array_equal(png.decode_png(_png(arr)),
                                  np.asarray(Image.open(io.BytesIO(_png(arr))).convert("RGB")))
    if mode == "RGB":
        np.testing.assert_array_equal(png.decode_png(png.encode_png(arr, {"comment": "a cat"})), arr)


def test_png_reader_refuses_what_it_does_not_read():
    rgb = np.zeros((4, 4, 3), np.uint8)
    palette = io.BytesIO()
    Image.fromarray(rgb).convert("P").save(palette, format="PNG")
    deep = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(deep, format="PNG")
    gray_alpha = io.BytesIO()
    Image.fromarray(rgb).convert("LA").save(gray_alpha, format="PNG")
    interlaced = bytearray(png.encode_png(rgb))
    interlaced[28] = 1  # IHDR's interlace byte
    for data in (palette.getvalue(), deep.getvalue(), gray_alpha.getvalue(), bytes(interlaced)):
        with pytest.raises(ValueError, match="8-bit non-interlaced"):
            png.decode_png(data)
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"\xff\xd8\xff\xe0 a jpeg")


# ------------------------------------------------- the route without Pillow


def _photo(h, w, seed):
    """Smooth structure plus fine detail, so a resize has aliasing to get wrong."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    chans = [np.sin(x / (5.0 + c)) * 70 + np.cos(y / (3.0 + 2 * c)) * 50 + 128 + ((x + y) % 2) * 20
             + rng.integers(-15, 16, (h, w)) for c in range(3)]
    return np.stack(chans, axis=2).clip(0, 255).astype(np.uint8)


@pytest.mark.parametrize("shape, size", [((480, 640), 64), ((300, 300), 256), ((37, 53), 16)])
def test_torch_resize_is_within_one_gray_level_of_pillow(shape, size):
    arr = _photo(*shape, seed=size)
    want = np.asarray(Image.fromarray(arr).resize((size, size), Image.BILINEAR), np.int64)
    got = coco.resize_u8_torch(arr, size)
    assert got.dtype == np.uint8 and got.shape == (size, size, 3)
    diff = np.abs(got.astype(np.int64) - want)
    assert diff.max() <= 1, diff.max()
    # a plain two-tap bilinear (no antialias) is far off at this downscale
    if shape[0] > 4 * size:
        x = torch.from_numpy(arr).permute(2, 0, 1)[None].float()
        plain = torch.nn.functional.interpolate(x, size=(size, size), mode="bilinear")[0].permute(1, 2, 0)
        assert (plain.numpy() - want).__abs__().max() > 10


def test_without_pillow_pngs_decode_and_anything_else_raises(monkeypatch):
    arr = _photo(96, 128, seed=3)
    data = _png(arr)
    with_pillow = {dt: fn(data, 32) for dt, fn in (("u8", coco.decode_resize_u8), ("f32", coco.decode_resize_normalize))}
    monkeypatch.setattr(coco, "_pillow", lambda: None)
    got = coco.decode_resize_u8(data, 32)
    assert got.dtype == np.uint8 and got.shape == (32, 32, 3)
    assert np.abs(got.astype(np.int64) - with_pillow["u8"]).max() <= 1
    got = coco.decode_resize_normalize(data, 32)
    assert got.dtype == np.float32 and np.abs(got - with_pillow["f32"]).max() <= 2 / 255 + 1e-6
    jpeg = io.BytesIO()
    Image.fromarray(arr).save(jpeg, format="JPEG")
    palette = io.BytesIO()
    Image.fromarray(arr).convert("P").save(palette, format="PNG")
    for data in (jpeg.getvalue(), palette.getvalue()):
        with pytest.raises(ImportError, match="Pillow"):
            coco.decode_resize_u8(data, 32)
    store = storage.MemoryStore()
    store.write_bytes("imgs/a.jpg", jpeg.getvalue())
    store.write_text("ann.json", json.dumps({"images": [{"id": 1, "file_name": "a.jpg"}],
                                             "annotations": [{"image_id": 1, "caption": "c"}]}))
    with pytest.raises(ImportError, match="Pillow"):
        coco.CocoCaptions(store, "imgs", "ann.json")[0]


def test_pillow_probe_reports_a_missing_pillow(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_pil(name, *args, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *args, **kw)

    assert coco._pillow() is Image
    monkeypatch.setattr(builtins, "__import__", no_pil)
    assert coco._pillow() is None
    data = png.encode_png(_photo(20, 20, seed=1))
    assert coco.decode_resize_u8(data, 8).shape == (8, 8, 3)
