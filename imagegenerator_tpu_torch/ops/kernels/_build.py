"""Build and load the package's CUDA kernels.

Every ``imagegenerator_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc``
for Hopper (``sm_90a``) into one shared library with a plain C interface,
at first use, and loaded with ``ctypes``. The library lands in
``build/kernels/<hash>/`` beside the package, keyed by a hash of the
sources and flags, so an edit to a source rebuilds and an unchanged tree
reuses what an earlier run built. Nothing here includes PyTorch's
headers, which keeps a build to seconds.

A wrapper passes tensors as ``data_ptr()`` integers and the stream as
``torch.cuda.current_stream().cuda_stream``; every C entry point returns
``cudaGetLastError()`` after its launch and the wrapper raises on
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


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / "libkernels.so"


@functools.cache
def library() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library. The compiler's
    output, including ``ptxas``'s register and shared-memory report, is
    kept in ``build.log`` beside the library."""
    so = library_path()
    if not so.exists():
        nvcc = find_nvcc()
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"libkernels.{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp)]
        cmd += [str(p) for p in _sources() if p.suffix == ".cu"]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        (so.parent / "build.log").write_text(
            " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with code {proc.returncode}:\n{proc.stderr}"
            )
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))


def build_log() -> str:
    """The compiler output of the current library's build, if any."""
    log = library_path().parent / "build.log"
    return log.read_text() if log.exists() else ""


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
