"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc``, all started
together, and the objects are linked into one shared library with a plain
C interface, which :mod:`ctypes` loads. The library goes under
``build/kernels/`` at the root of the checkout, named by a hash of the
sources and flags, so an edit rebuilds and an unchanged tree reuses the last
build. Nothing here runs at import: the first call of :func:`load` builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

_PKG = pathlib.Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills, into the log
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc's output of the build this process ran ("" if reused)
build_seconds = 0.0


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``, the toolkit's standard install location)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[pathlib.Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libdart_kernels-{h.hexdigest()[:16]}.so"


def compile_library(sources: list[pathlib.Path], out: pathlib.Path) -> str:
    """Compile ``sources`` (one nvcc each, all started together, with
    ``NVCC_FLAGS``) and link them into the shared library ``out``, written
    under a temporary name and moved into place. Returns nvcc's output;
    raises if a step fails."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    try:
        procs = [
            subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(sources, objs)
        ]
        log = "".join(p.communicate()[0] for p in procs)
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError(f"nvcc failed:\n{log[-4000:]}")
        link = subprocess.run(
            [nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{log[-4000:]}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return log


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first use. Raises if the build
    fails; there is no fallback."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            t0 = time.perf_counter()
            build_log = compile_library(_sources(), out)
            build_seconds = time.perf_counter() - t0
        _lib = ctypes.CDLL(str(out))
        return _lib
