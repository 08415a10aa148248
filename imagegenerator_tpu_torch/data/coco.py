"""COCO caption <-> image dataset — the port's own copy of
``imagegenerator_tpu/data/coco.py``.

A caption <-> file_name manifest is built from the COCO
``captions_*.json`` annotation file (fetched once through a shared
``BlobStore``), and ``CocoCaptions`` serves (caption, decoded and resized
image) samples; ``(host_index, host_count)`` slices the manifest per host.

Decoding takes one of two routes, decided by whether Pillow is installed:

* with Pillow: ``Image.open -> convert("RGB") -> resize(BILINEAR)``, the
  JAX package's Pillow route, so both packages serve the same pixels;
* without it: 8-bit non-interlaced gray / RGB / RGBA PNGs are read by
  ``utils/png.py::decode_png`` and resized on the CPU with
  ``F.interpolate(mode="bilinear", antialias=True)``, the same antialiased
  triangle filter as PIL's ``BILINEAR`` (within 1 gray level of it). Any
  other image (a JPEG, a palette or 16-bit PNG) raises an ``ImportError``
  that names Pillow.

The JAX package's C++ host ops (``data/native.py``) are not ported.
"""

from __future__ import annotations

import io
import json
from dataclasses import dataclass

import numpy as np

from imagegenerator_tpu_torch.data.storage import BlobStore


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


def decode_resize_u8(data: bytes, size: int) -> np.ndarray:
    """JPEG/PNG bytes -> uint8 NHWC image at (size, size), resampled but
    not normalised: the train step maps uint8 to [-1, 1] on the device,
    so each image crosses the host-to-device link at a quarter of the f32
    bytes."""
    Image = _pillow()
    if Image is not None:
        img = Image.open(io.BytesIO(data)).convert("RGB")
        return np.asarray(img.resize((size, size), Image.BILINEAR), np.uint8)

    from imagegenerator_tpu_torch.utils.png import decode_png

    try:
        rgb = decode_png(data)
    except ValueError as e:
        raise ImportError(
            f"decoding this image needs Pillow, which is not installed ({e}); without it "
            "only 8-bit non-interlaced gray, RGB and RGBA PNGs are read"
        ) from e
    return resize_u8_torch(rgb, size)


def decode_resize_normalize(data: bytes, size: int) -> np.ndarray:
    """JPEG/PNG bytes -> float32 NHWC image in [-1, 1] at (size, size):
    the resampled bytes of ``decode_resize_u8`` over 255, times 2, minus
    1 (the JAX package's Pillow route)."""
    return decode_resize_u8(data, size).astype(np.float32) / 255.0 * 2.0 - 1.0


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

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, index: int) -> tuple[str, np.ndarray]:
        e = self.entries[index]
        data = self.store.read_bytes(f"{self.root}/{e.file_name}")
        if self.image_dtype == "uint8":
            return e.caption, decode_resize_u8(data, self.image_size)
        return e.caption, decode_resize_normalize(data, self.image_size)
