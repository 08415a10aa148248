"""Build and load the package's CUDA kernels.

Each ``imagegenerator_tpu_torch/csrc/<name>.cu`` is compiled by its own
``nvcc`` for Hopper (``sm_90a``) into a shared library
``lib<name>.so`` with a plain C interface, and loaded with ``ctypes``.
``build_all`` starts one ``nvcc`` per source, all at once, and waits for
them; ``library(name)`` builds (if needed) and loads one. The libraries
land in ``build/kernels/<hash>/`` beside the package, keyed by a hash of
the sources (headers included) and flags, so an edit to a source
rebuilds and an unchanged tree reuses what an earlier run built. Nothing
here includes PyTorch's headers, which keeps a build to seconds.

A wrapper passes tensors as ``data_ptr()`` integers and the stream as
the integer handle of PyTorch's current stream (``raw_stream()`` gives the
cheapest way to read it); every C entry point returns
``cudaGetLastError()`` after its launches and the wrapper raises on
anything but 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """``nvcc`` on ``PATH``, else under ``$CUDA_HOME`` or the default
    toolkit prefix; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME: the CUDA kernels "
        "cannot be built"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def names() -> list[str]:
    """The kernel sources, one library each: ``csrc/<name>.cu``."""
    return [p.stem for p in sorted(CSRC.glob("*.cu"))]


def build_dir() -> Path:
    """Where the libraries for the current sources live (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def _start(name: str):
    """Start ``nvcc`` for ``csrc/<name>.cu``; returns the process, or None
    when the library is already built."""
    so = library_path(name)
    if so.exists():
        return None
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"lib{name}.{os.getpid()}.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, cmd, tmp, so


def _finish(name: str, started) -> None:
    proc, cmd, tmp, so = started
    out, err = proc.communicate()
    (so.parent / f"{name}.build.log").write_text(" ".join(cmd) + "\n" + out + err)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu with code {proc.returncode}:\n{err}")
    os.replace(tmp, so)


def build_all() -> None:
    """Compile every source that is not built yet, one ``nvcc`` each,
    all started together. The compiler's output, including ``ptxas``'s
    register and shared-memory report, is kept in ``<name>.build.log``."""
    started = {name: _start(name) for name in names()}
    try:
        for name, s in started.items():
            if s is not None:
                _finish(name, s)
    finally:
        for s in started.values():
            if s is not None and s[0].poll() is None:
                s[0].kill()
                s[0].wait()


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """Compile (if needed) and load ``lib<name>.so``."""
    started = _start(name)
    if started is not None:
        _finish(name, started)
    return ctypes.CDLL(str(library_path(name)))


def build_log(name: str) -> str:
    """The compiler output of a library's current build, if any."""
    log = build_dir() / f"{name}.build.log"
    return log.read_text() if log.exists() else ""


@functools.cache
def raw_stream():
    """The function ``index -> handle`` that gives the current stream of
    a device index as the integer a C entry point takes: PyTorch's raw
    getter where it has one (no ``Stream`` object is made), else
    ``torch.cuda.current_stream(index).cuda_stream``."""
    import torch

    getter = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if getter is None:
        return lambda index: torch.cuda.current_stream(index).cuda_stream
    return getter


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
