"""The port's native executor library is built so that processes started
together never load a half-written file: each compiles under a temporary
name and moves the result into place (``runtime/rt_executor.py``)."""

import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

_PROBE = (
    "import pathlib, sys\n"
    f"sys.path.insert(0, {str(ROOT)!r})\n"
    "from dart_planner_tpu_torch.runtime import rt_executor as rt\n"
    "rt._LIB_PATH = pathlib.Path(sys.argv[1])\n"
    "print(rt.native_available(), rt._lib_error)\n"
)


def test_processes_started_together_all_load_the_library(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the native executor")
    lib = tmp_path / "librt_executor.so"
    procs = [
        subprocess.Popen([sys.executable, "-c", _PROBE, str(lib)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(6)
    ]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err[-500:] for _, err in outs]
    assert [out.split()[0] for out, _ in outs] == ["True"] * 6, outs
    assert sorted(f.name for f in tmp_path.iterdir()) == [lib.name]  # no temporary left
