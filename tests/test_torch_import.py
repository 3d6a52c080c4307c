"""The PyTorch port stands alone: it imports with jax blocked, and no file
of it, of its smoke test, of its benchmark (``bench_torch.py``), of its
examples or of its scripts (``scripts/*_torch.py``,
``scripts/fork_lapack_hang.py``) imports jax, flax or the JAX package."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "dart_planner_tpu_torch"
SCRIPTS = sorted((ROOT / "scripts").glob("*_torch.py")) + [ROOT / "scripts" / "fork_lapack_hang.py"]
SOURCES = (sorted(p for p in PKG.rglob("*.py"))
           + [ROOT / "chip_smoke.py", ROOT / "bench_torch.py"]
           + sorted((ROOT / "examples_torch").rglob("*.py")) + SCRIPTS)


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


# the JAX package's modules the port took last: each is scanned above
LAST_MODULES = (
    "hardware/mavlink_adapter.py", "hardware/airsim_interface.py",
    "hardware/secure_interface.py", "hardware/mixing_schema.py",
    "hardware/motor_calibration.py", "runtime/multiprocess_loop.py",
    "gateway/__init__.py", "gateway/middleware.py",
    *(f"security/{m}.py" for m in (
        "auth", "permissions", "rate_limiter", "secure_files", "key_derivation",
        "file_verification", "db", "manage_users", "key_manager", "credentials",
        "credential_helpers", "os_keyring")),
)


# the port's counterparts of the JAX package's scripts
PORTED_SCRIPTS = ("diag_convergence", "measure_scaling", "diag_newton_decrement", "diag_tail",
                  "diag_stuck", "diag_fixes", "diag_timeouts", "diag_goalclamp",
                  "diag_unknown")


def test_the_ported_scripts_are_scanned():
    """Each JAX script with a counterpart has it as ``<name>_torch.py``, and
    the scan above covers it."""
    for name in PORTED_SCRIPTS:
        assert (ROOT / "scripts" / f"{name}.py").exists(), name
        assert ROOT / "scripts" / f"{name}_torch.py" in SOURCES, name


def test_the_bench_is_ported_and_scanned():
    """bench.py has its counterpart, the root ``bench_torch.py``, and the scan
    above covers it; so does it the CLI that runs it."""
    assert (ROOT / "bench.py").exists()
    assert ROOT / "bench_torch.py" in SOURCES
    assert PKG / "apps" / "cli.py" in SOURCES
    assert "bench_torch.py" in (PKG / "apps" / "cli.py").read_text()


def test_the_last_modules_are_ported_and_scanned():
    """Every module of the JAX package has its counterpart (the two Pallas
    files aside: their kernels are ``csrc/``), and the scans above cover the
    ones ported last."""
    jax_pkg = ROOT / "dart_planner_tpu"
    ported = {p.relative_to(PKG) for p in PKG.rglob("*.py")}
    for rel in LAST_MODULES:
        assert PKG / rel in SOURCES, rel
    missing = sorted(
        str(rel) for rel in (p.relative_to(jax_pkg) for p in jax_pkg.rglob("*.py"))
        if rel not in ported and rel.name not in ("pallas_mpc.py", "pallas_rollout.py")
    )
    assert not missing, missing
