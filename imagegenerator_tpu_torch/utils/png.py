"""A PNG writer and reader on the standard library alone (``zlib`` +
``struct``).

The writer makes 8-bit RGB images with text chunks, the artifact the
sampling CLI produces: one PNG per sample with its caption under the
``comment`` key. A text that Latin-1 cannot encode goes into an ``iTXt``
(UTF-8) chunk, as Pillow does; any other into ``tEXt``.

The reader, ``decode_png``, is what the dataset decodes with where Pillow
is not installed: 8-bit non-interlaced gray, RGB and RGBA, all five
filter types. The average and Paeth filters are undone byte by byte in
Python (about a second for a 640 x 480 image); the writer here uses
filter type 0 alone.
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


def _chunks(data: bytes):
    at = len(_SIGNATURE)
    while at + 8 <= len(data):
        (length,) = struct.unpack(">I", data[at:at + 4])
        yield data[at + 4:at + 8], data[at + 8:at + 8 + length]
        at += 12 + length


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the five PNG filter types (none, sub, up, average, Paeth) on
    ``h`` rows of ``1 + stride`` bytes; ``bpp`` bytes per pixel."""
    out = np.zeros((h + 1, bpp + stride), np.uint8)  # a zero row above, zero pixel to the left
    rows = np.frombuffer(raw, np.uint8, h * (1 + stride)).reshape(h, 1 + stride)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        cur, up = out[y + 1], out[y]
        if kind == 0:
            cur[bpp:] = line
        elif kind == 1:  # each byte plus the byte one pixel to the left: a running sum mod 256
            cur[bpp:] = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur[bpp:] = line + up[bpp:]
        elif kind in (3, 4):  # sequential along the row
            row, above, src = bytearray(bpp + stride), up.tolist(), line.tolist()
            for x in range(stride):
                a, b = row[x], above[x + bpp]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = above[x]
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                row[x + bpp] = (src[x] + pred) & 0xFF
            cur[:] = np.frombuffer(bytes(row), np.uint8)
        else:
            raise ValueError(f"PNG filter type {kind}")
    return out[1:, bpp:]


def decode_png(data: bytes) -> np.ndarray:
    """``(H, W, 3)`` uint8 RGB of an 8-bit, non-interlaced gray, RGB or
    RGBA PNG, as Pillow's ``Image.open(...).convert("RGB")`` gives it
    (gray is repeated over the channels, alpha is dropped). Any other PNG
    (palette, 16-bit, gray + alpha, interlaced) raises ``ValueError``."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG")
    ihdr, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, colour, _, _, interlace = ihdr
    channels = {0: 1, 2: 3, 6: 4}.get(colour)
    if depth != 8 or channels is None or interlace:
        raise ValueError(
            f"PNG with bit depth {depth}, colour type {colour}, interlace {interlace}: only "
            "8-bit non-interlaced gray, RGB and RGBA are read without Pillow"
        )
    pixels = _unfilter(zlib.decompress(b"".join(idat)), h, w * channels, channels)
    pixels = pixels.reshape(h, w, channels)
    if channels == 1:
        return np.repeat(pixels, 3, axis=2)
    return np.ascontiguousarray(pixels[:, :, :3])
