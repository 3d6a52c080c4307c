"""Kernel B1's own source compiled by g++ for the CPU, as nvcc builds it,
for the tests of its wrapper (``cuda_mpc.run_library``): a module of its
own, without JAX, so that the test files of the port's tracing and of long
horizons share it.

``csrc/mpc_solve.cu`` and ``csrc/mpc_solve_steps.cu`` (which includes it)
are compiled (C++20) as two translation units against
``csrc/emulation/cuda_runtime.h`` and bound with the kernel's C interface:
its one ``<<<...>>>`` launch becomes a call of the header's launcher;
``-mfma -ffp-contract=fast`` contracts into FMAs as nvcc does, square roots
and divisions stay IEEE as nvcc's defaults. A 16-scenario round at N=128
takes about a tenth of a second (the build, about six).
"""

import ctypes
import pathlib
import re
import shutil
import subprocess

import pytest

from dart_planner_tpu_torch.ops import _build, cuda_mpc

# the shared memory, in each of the kernel's translation units, and the
# setter of the emulated card's opt-in shared memory, once
_EMULATION_SMEM = """
namespace { float smem[1 << 22]; }
"""
_EMULATION_GLOBALS = """
#include <cuda_runtime.h>
extern "C" void emu_set_smem_optin(int bytes) { emu_smem_optin = bytes; }
"""


def build_emulated_library(out: pathlib.Path) -> ctypes.CDLL:
    """Compile the emulated kernel into ``out`` and bind it; skips the
    calling test where there is no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel's CPU emulation")
    source = _build.SRC_DIR / "mpc_solve.cu"
    text, n = re.subn(r"(\w+<S>)<<<([^>]*)>>>\(", r"emu_launch(\1, \2, ", source.read_text())
    assert n == 1, f"{source}: expected one kernel launch, found {n}"
    (out / "mpc_solve.cu").write_text(text + _EMULATION_SMEM)
    shutil.copy(_build.SRC_DIR / "mpc_solve_steps.cu", out)
    (out / "emulation.cpp").write_text(_EMULATION_GLOBALS)
    subprocess.run([gxx, "-std=c++20", "-O2", "-mfma", "-ffp-contract=fast", "-fPIC",
                    "-shared", f"-I{_build.SRC_DIR / 'emulation'}",
                    "-o", str(out / "libmpc_solve.so"), "-x", "c++",
                    *(str(out / f) for f in ("mpc_solve.cu", "mpc_solve_steps.cu",
                                             "emulation.cpp"))],
                   check=True, capture_output=True, text=True)
    lib = cuda_mpc.bind(ctypes.CDLL(str(out / "libmpc_solve.so")))
    assert lib.mpc_params_size() == ctypes.sizeof(cuda_mpc._Params)
    lib.emu_set_smem_optin.argtypes = [ctypes.c_int]
    return lib
