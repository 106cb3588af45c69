"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them.

Each library is compiled on first use into ``pytv4d_tpu_torch/_build/``
(ignored by git), under a name keyed by a hash of its source, the headers
it includes from ``csrc/`` and the flags, so a fresh checkout builds it
once and a changed source or header builds anew.  The result
is a shared library with a plain C interface, loaded with ``ctypes``:
compiling against PyTorch's headers would cost minutes per build.

A missing ``nvcc`` or a failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
# and per source: the sources of the specialised kernels instantiate a
# kernel per channel table and storage (B1 and B4 168, B3 and B5 252, the
# sharded CP passes 240, the boundary kernels 72, the z-marching pass A 36,
# the on-chip whole solves 42), which nvcc compiles on every core
SOURCE_FLAGS = {"specialised": ("-split-compile", "0"),
                "specialised_tv": ("-split-compile", "0"),
                "specialised_cp": ("-split-compile", "0"),
                "cp_boundary": ("-split-compile", "0"),
                "cp_zstream": ("-split-compile", "0"),
                "resident_onchip": ("-split-compile", "0")}


def nvcc_flags(name: str) -> tuple:
    """The flags ``csrc/<name>.cu`` is compiled with."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


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


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources(source: str) -> list:
    """``source`` and every file it includes with ``#include "..."`` from
    its own directory, transitively, each once, in a fixed order (a quoted
    name that is not there is the compiler's to find elsewhere)."""
    seen, todo = [], [os.path.abspath(source)]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        with open(path, "rb") as f:
            for name in _INCLUDE.findall(f.read()):
                inc = os.path.normpath(os.path.join(os.path.dirname(path),
                                                    name.decode()))
                if os.path.isfile(inc):
                    todo.append(inc)
    return seen


def _library_path(source: str) -> str:
    stem = os.path.splitext(os.path.basename(source))[0]
    digest = hashlib.sha256()
    for path in _sources(source):
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(nvcc_flags(stem)).encode())
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
        proc = subprocess.run([nvcc, *nvcc_flags(name), "-o", tmp, source],
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
