"""COCO caption <-> image dataset — the port's own copy of
``imagegenerator_tpu/data/coco.py``.

A caption <-> file_name manifest is built from the COCO
``captions_*.json`` annotation file (fetched once through a shared
``BlobStore``), and ``CocoCaptions`` serves (caption, decoded and resized
image) samples; ``(host_index, host_count)`` slices the manifest per host.

Decoding takes the JAX package's order (``imagegenerator_tpu/data/
coco.py``):

* a JPEG through the C++ host ops (``data/native.py``: libjpeg decode and
  resample in one call, DCT-domain scaled decode unless
  ``IMAGEGEN_FAST_DCT=0``) where they built with libjpeg;
* otherwise the bytes are decoded by Pillow where it is installed, else
  by ``utils/png.py::decode_png`` (8-bit non-interlaced gray / RGB / RGBA
  PNGs; anything else raises an ``ImportError`` that names Pillow), and
  resampled by the host ops' antialiased triangle filter where they
  built, else by Pillow's ``resize(BILINEAR)``, else by
  ``F.interpolate(mode="bilinear", antialias=True)`` on the CPU (within 1
  gray level of Pillow's).

``describe_routes()`` names the decoder and resampler this process takes;
``CocoCaptions`` prints it once, to stderr.
"""

from __future__ import annotations

import functools
import io
import json
import os
import sys
from dataclasses import dataclass

import numpy as np

from imagegenerator_tpu_torch.data import native
from imagegenerator_tpu_torch.data.storage import BlobStore

_JPEG = b"\xff\xd8"


@dataclass(frozen=True)
class ManifestEntry:
    caption: str
    file_name: str


def build_manifest(store: BlobStore, ann_file: str) -> list[ManifestEntry]:
    """annotation JSON -> [(caption, file_name)] via an image_id join."""
    anns = json.loads(store.read_text(ann_file))
    id_to_file = {img["id"]: img["file_name"] for img in anns["images"]}
    out = []
    for ann in anns["annotations"]:
        fname = id_to_file.get(ann["image_id"])
        if fname is not None:
            out.append(ManifestEntry(caption=ann["caption"], file_name=fname))
    return out


def _pillow():
    """The ``PIL.Image`` module, or None where Pillow is not installed."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def resize_u8_torch(rgb: np.ndarray, size: int) -> np.ndarray:
    """``(H, W, 3)`` uint8 -> ``(size, size, 3)`` uint8 by the antialiased
    bilinear (triangle) filter, rounded to nearest."""
    import torch
    import torch.nn.functional as F

    x = torch.from_numpy(np.ascontiguousarray(rgb)).permute(2, 0, 1)[None].float()
    y = F.interpolate(x, size=(size, size), mode="bilinear", antialias=True, align_corners=False)
    return (y[0].permute(1, 2, 0) + 0.5).floor().clamp(0, 255).to(torch.uint8).numpy()


def _fast_dct() -> bool:
    return os.environ.get("IMAGEGEN_FAST_DCT", "1") != "0"


def _decode_png(data: bytes) -> np.ndarray:
    """RGB uint8 by the standard-library PNG reader (no Pillow here)."""
    from imagegenerator_tpu_torch.utils.png import decode_png

    try:
        return decode_png(data)
    except ValueError as e:
        raise ImportError(
            f"decoding this image needs Pillow, which is not installed ({e}); without it "
            "only 8-bit non-interlaced gray, RGB and RGBA PNGs are read"
        ) from e


def describe_routes() -> str:
    """Which decoder and resampler ``decode_resize_*`` take here."""
    pillow = _pillow() is not None
    decoders = ["C++ host ops (libjpeg) for JPEGs"] if native.jpeg() else []
    decoders.append("Pillow" if pillow else "the standard-library PNG reader (no Pillow)")
    if native.available():
        resampler = "the C++ host ops' antialiased triangle filter"
    elif pillow:
        resampler = "Pillow's resize(BILINEAR) (no C++ host ops)"
    else:
        resampler = "torch's antialiased bilinear interpolate (no C++ host ops, no Pillow)"
    return f"decoded by {', else '.join(decoders)}; resampled by {resampler}"


@functools.cache
def _announce() -> None:
    print(f"[data] images {describe_routes()}", file=sys.stderr, flush=True)


def decode_resize_u8(data: bytes, size: int) -> np.ndarray:
    """JPEG/PNG bytes -> uint8 NHWC image at (size, size), resampled but
    not normalised: the train step maps uint8 to [-1, 1] on the device,
    so each image crosses the host-to-device link at a quarter of the f32
    bytes."""
    if data[:2] == _JPEG and native.jpeg():
        out = native.decode_jpeg_resize_u8(data, size, fast_dct=_fast_dct())
        if out is not None:
            return out
    Image = _pillow()
    if Image is not None:
        img = Image.open(io.BytesIO(data)).convert("RGB")
        if native.available():
            return native.resize_u8(np.asarray(img, np.uint8), size)
        return np.asarray(img.resize((size, size), Image.BILINEAR), np.uint8)
    rgb = _decode_png(data)
    return native.resize_u8(rgb, size) if native.available() else resize_u8_torch(rgb, size)


def decode_resize_normalize(data: bytes, size: int) -> np.ndarray:
    """JPEG/PNG bytes -> float32 NHWC image in [-1, 1] at (size, size).
    The host ops resample to f32 directly; the Pillow and torch routes
    resample to uint8 first, then over 255, times 2, minus 1 (the JAX
    package's Pillow route)."""
    if data[:2] == _JPEG and native.jpeg():
        out = native.decode_jpeg_resize_normalize(data, size, fast_dct=_fast_dct())
        if out is not None:
            return out
    Image = _pillow()
    if Image is not None:
        img = Image.open(io.BytesIO(data)).convert("RGB")
        if native.available():
            return native.resize_normalize(np.asarray(img, np.uint8), size)
        u8 = np.asarray(img.resize((size, size), Image.BILINEAR), np.uint8)
    else:
        rgb = _decode_png(data)
        if native.available():
            return native.resize_normalize(rgb, size)
        u8 = resize_u8_torch(rgb, size)
    return u8.astype(np.float32) / 255.0 * 2.0 - 1.0


class CocoCaptions:
    """Random-access (caption, image) dataset with host sharding.
    ``image_dtype``: ``uint8`` (default; resampled bytes, normalised on
    the device by the train step) or ``float32`` (normalised on the
    host)."""

    def __init__(
        self,
        store: BlobStore,
        root: str,
        ann_file: str,
        image_size: int = 64,
        host_index: int = 0,
        host_count: int = 1,
        image_dtype: str = "uint8",
    ):
        if image_dtype not in ("uint8", "float32"):
            raise ValueError(f"image_dtype must be uint8|float32, got {image_dtype}")
        self.store = store
        self.root = root.rstrip("/")
        self.image_size = image_size
        self.image_dtype = image_dtype
        full = build_manifest(store, ann_file)
        # contiguous per-host shard; the ragged tail is dropped so every
        # host sees the same number of samples
        per_host = len(full) // host_count
        self.entries = full[host_index * per_host : (host_index + 1) * per_host]
        _announce()

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, index: int) -> tuple[str, np.ndarray]:
        e = self.entries[index]
        data = self.store.read_bytes(f"{self.root}/{e.file_name}")
        if self.image_dtype == "uint8":
            return e.caption, decode_resize_u8(data, self.image_size)
        return e.caption, decode_resize_normalize(data, self.image_size)
