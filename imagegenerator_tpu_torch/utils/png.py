"""A PNG writer on the standard library alone (``zlib`` + ``struct``).

Writes 8-bit RGB images with text chunks, the artifact the sampling CLI
produces: one PNG per sample with its caption under the ``comment`` key.
A text that Latin-1 cannot encode goes into an ``iTXt`` (UTF-8) chunk,
as Pillow does; any other into ``tEXt``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def _text_chunk(key: str, value: str) -> bytes:
    try:
        return _chunk(b"tEXt", key.encode("latin-1") + b"\0" + value.encode("latin-1"))
    except UnicodeEncodeError:
        # keyword, null, compression flag and method, empty language tag
        # and translated keyword (each null-terminated), then UTF-8 text
        head = key.encode("latin-1") + b"\0\0\0\0\0"
        return _chunk(b"iTXt", head + value.encode("utf-8"))


def encode_png(rgb: np.ndarray, text: dict[str, str] | None = None) -> bytes:
    """PNG bytes of an ``(H, W, 3)`` uint8 array."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {rgb.shape} {rgb.dtype}")
    h, w, _ = rgb.shape
    # colour type 2 (RGB), 8 bits, no interlace; filter type 0 on each row
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    chunks = [_chunk(b"IHDR", ihdr)]
    chunks += [_text_chunk(k, v) for k, v in (text or {}).items()]
    chunks += [_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)), _chunk(b"IEND", b"")]
    return _SIGNATURE + b"".join(chunks)


def write_png(path: str, rgb: np.ndarray, text: dict[str, str] | None = None) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(rgb, text))
