"""The PyTorch port stands alone: it imports with jax blocked, and no file
of it imports jax or flax."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "dart_planner_tpu_torch"
SOURCES = sorted(p for p in PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _module_names():
    names = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def test_port_imports_with_jax_blocked():
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for name in {_module_names()!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'dart_planner_tpu' or m.startswith('dart_planner_tpu.')"
        " for m in sys.modules)\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=ROOT, timeout=240,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


_JAX_IMPORT = re.compile(
    r"^\s*(import\s+(jax|flax)\b|from\s+(jax|flax)(\.|\s)|"
    r"(import|from)\s+dart_planner_tpu(\.|\s|$))",
    re.MULTILINE,
)


@pytest.mark.parametrize(
    "path", SOURCES, ids=[str(p.relative_to(ROOT)) for p in SOURCES]
)
def test_source_never_imports_jax(path):
    found = _JAX_IMPORT.findall(path.read_text())
    assert not found, f"{path.name} imports jax, flax or the JAX package"
