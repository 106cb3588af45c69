"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them.

Each library is compiled on first use into ``pytv4d_tpu_torch/_build/``
(ignored by git), under a name keyed by a hash of its source and flags, so a
fresh checkout builds it once and a changed source builds anew.  The result
is a shared library with a plain C interface, loaded with ``ctypes``:
compiling against PyTorch's headers would cost minutes per build.

A missing ``nvcc`` or a failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)


class BuildError(RuntimeError):
    pass


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` / PyTorch's CUDA_HOME."""
    path = shutil.which("nvcc")
    if path:
        return path
    from torch.utils.cpp_extension import CUDA_HOME

    for home in (os.environ.get("CUDA_HOME"), CUDA_HOME):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise BuildError("nvcc not found (PATH, $CUDA_HOME): the CUDA kernels "
                     "cannot be built")


def _library_path(source: str) -> str:
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> tuple:
    """Compile ``csrc/<name>.cu`` unless its keyed library exists.

    Returns ``(path, seconds, compiler_log)``; seconds is 0.0 and the log
    empty when the library was already built."""
    source = os.path.join(CSRC, f"{name}.cu")
    out = _library_path(source)
    if os.path.isfile(out):
        return out, 0.0, ""
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, source],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise BuildError(f"nvcc failed on {source} "
                             f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    with open(out + ".log", "w") as f:
        f.write(log)
    return out, seconds, log


def load(name: str) -> ctypes.CDLL:
    """Load the library for ``csrc/<name>.cu``, building it if needed (the
    caller keeps the handle: ``kernels.fused._lib`` caches it)."""
    path, _, _ = build(name)
    return ctypes.CDLL(path)
