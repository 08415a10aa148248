"""``ctypes`` bindings to the C++ host ops (``native/host_ops.cpp``: JPEG
decode and the antialiased triangle resample of Pillow's ``BILINEAR``,
with the interpreter lock released) — the port's own copy of
``imagegenerator_tpu/data/native.py``, with its entry points.

The library is built on first use with ``g++`` into
``build/native/<hash of the source, the flags and the host's CPU>/
libhost_ops.so`` beside the package (``build/`` is ignored by git; the
CPU is in the key because ``-march=native`` code does not move between
CPUs), never next to the source: first
with ``-ljpeg``, and where that fails (no libjpeg headers or library)
again with ``-DHOST_OPS_NO_JPEG``, whose JPEG entry points report
failure. ``jpeg()`` says which build loaded; ``available()`` whether any
did (no ``g++``, or both builds failing, leaves none). The callers in
``data/coco.py`` choose their route from these two and say which.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[2] / "native" / "host_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread")

_u8p = ctypes.POINTER(ctypes.c_uint8)
_f32p = ctypes.POINTER(ctypes.c_float)
_int = ctypes.c_int
_SIGNATURES = {
    "resize_normalize_u8_to_f32": (None, [_u8p, _int, _int, _int, _f32p, _int, _int]),
    "batch_resize_normalize_u8_to_f32": (
        None, [ctypes.POINTER(_u8p), ctypes.POINTER(_int), ctypes.POINTER(_int), _int, _int, _f32p,
               _int, _int, _int]),
    "resample_u8_to_u8": (None, [_u8p, _int, _int, _int, _u8p, _int, _int]),
    "decode_jpeg_resize_normalize": (_int, [_u8p, ctypes.c_int64, _f32p, _int, _int, _int, _int]),
    "decode_jpeg_resize_u8": (_int, [_u8p, ctypes.c_int64, _u8p, _int, _int, _int, _int]),
}


def _cpu() -> str:
    """The host's CPU model, as far as the system says."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((line for line in f if line.startswith("model name")), platform.processor())
    except OSError:
        return platform.processor()


def library_path(with_jpeg: bool) -> Path:
    """Where the build of the current source with these flags, on this
    kind of CPU, lands."""
    ident = repr((FLAGS, with_jpeg, platform.machine(), _cpu())).encode()
    key = hashlib.sha256(SRC.read_bytes() + ident).hexdigest()[:16]
    return BUILD_DIR / key / ("libhost_ops.so" if with_jpeg else "libhost_ops_nojpeg.so")


def _build(with_jpeg: bool) -> Path | None:
    """The library at ``library_path``, built if it is not there yet
    (into a temporary name, then renamed, so processes that build at once
    never load a torn file); None when the compiler fails."""
    out = library_path(with_jpeg)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    extra = ["-ljpeg"] if with_jpeg else ["-DHOST_OPS_NO_JPEG"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", *FLAGS, str(SRC), "-o", tmp, *extra], check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, out)
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.cache
def _load() -> tuple[ctypes.CDLL | None, bool]:
    """``(library, built with libjpeg)``, or ``(None, False)``."""
    for with_jpeg in (True, False):
        path = _build(with_jpeg)
        if path is not None:
            lib = ctypes.CDLL(str(path))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            return lib, with_jpeg
    return None, False


def get_lib() -> ctypes.CDLL | None:
    return _load()[0]


def available() -> bool:
    return get_lib() is not None


def jpeg() -> bool:
    """Whether the loaded library decodes JPEGs (built with libjpeg)."""
    return _load()[1]


def _ptr(arr, kind):
    return arr.ctypes.data_as(kind)


def _decode_jpeg(entry, data: bytes, size: int, channels: int, fast_dct: bool, dtype, kind):
    lib = get_lib()
    if lib is None or not jpeg():
        return None
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((size, size, channels), dtype)
    rc = getattr(lib, entry)(_ptr(buf, _u8p), ctypes.c_int64(len(data)), _ptr(out, kind), size, size,
                             channels, int(fast_dct))
    return out if rc == 0 else None


def decode_jpeg_resize_normalize(data: bytes, size: int, channels: int = 3,
                                 fast_dct: bool = False) -> np.ndarray | None:
    """JPEG bytes -> float32 ``(size, size, C)`` in [-1, 1], decode,
    resample and normalise in C++. ``fast_dct`` decodes at the smallest
    1/8-granular scale still at least the target. None when the decode
    fails or the library has no libjpeg."""
    return _decode_jpeg("decode_jpeg_resize_normalize", data, size, channels, fast_dct, np.float32, _f32p)


def decode_jpeg_resize_u8(data: bytes, size: int, channels: int = 3,
                          fast_dct: bool = False) -> np.ndarray | None:
    """JPEG bytes -> uint8 ``(size, size, C)``, resampled and rounded as
    Pillow rounds its uint8 output, not normalised. None when the decode
    fails or the library has no libjpeg."""
    return _decode_jpeg("decode_jpeg_resize_u8", data, size, channels, fast_dct, np.uint8, _u8p)


def _lib_or_raise() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"the native host ops did not build (g++ on {SRC})")
    return lib


def resize_u8(img_u8: np.ndarray, size: int) -> np.ndarray:
    """uint8 HWC -> uint8 ``(size, size, C)``: the antialiased triangle
    resample with Pillow's uint8 rounding."""
    lib = _lib_or_raise()
    img_u8 = np.ascontiguousarray(img_u8, np.uint8)
    h, w, c = img_u8.shape
    out = np.empty((size, size, c), np.uint8)
    lib.resample_u8_to_u8(_ptr(img_u8, _u8p), h, w, c, _ptr(out, _u8p), size, size)
    return out


def resize_normalize(img_u8: np.ndarray, size: int) -> np.ndarray:
    """uint8 HWC -> float32 ``(size, size, C)`` in [-1, 1] (the
    antialiased triangle resample, Pillow ``BILINEAR`` semantics)."""
    lib = _lib_or_raise()
    img_u8 = np.ascontiguousarray(img_u8, np.uint8)
    h, w, c = img_u8.shape
    out = np.empty((size, size, c), np.float32)
    lib.resize_normalize_u8_to_f32(_ptr(img_u8, _u8p), h, w, c, _ptr(out, _f32p), size, size)
    return out


def batch_resize_normalize(imgs_u8: list[np.ndarray], size: int, num_threads: int = 8) -> np.ndarray:
    """uint8 HWC images of one channel count -> one ``(N, size, size, C)``
    float32 batch, resampled on ``num_threads`` threads."""
    lib = _lib_or_raise()
    imgs_u8 = [np.ascontiguousarray(im, np.uint8) for im in imgs_u8]
    n, c = len(imgs_u8), imgs_u8[0].shape[2]
    if any(im.ndim != 3 or im.shape[2] != c for im in imgs_u8):
        raise ValueError("every image must be HWC with the same channel count")
    out = np.empty((n, size, size, c), np.float32)
    ptrs = (_u8p * n)(*[_ptr(im, _u8p) for im in imgs_u8])
    shs = (_int * n)(*[im.shape[0] for im in imgs_u8])
    sws = (_int * n)(*[im.shape[1] for im in imgs_u8])
    lib.batch_resize_normalize_u8_to_f32(ptrs, shs, sws, c, n, _ptr(out, _f32p), size, size, num_threads)
    return out
