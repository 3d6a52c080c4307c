"""The JAX package's import-layering contract (tests/test_import_layering.py)
applied to the PyTorch port by AST scan, with no module imported:

1. module-level imports respect the layer ranks (a subpackage imports only
   subpackages of strictly lower rank; the same subpackage is free);
2. ``common``/``ops``/``planning``/``control`` never import
   ``hardware``/``comms``/``apps``, not even lazily inside a function.

The ranks are the JAX package's own (``RANK`` there), so the port keeps its
reference's layering; a subpackage the port adds must be ranked there too.
"""

import ast
from pathlib import Path

import pytest

from test_import_layering import CORE, FORBIDDEN_FOR_CORE, RANK

PKG = "dart_planner_tpu_torch"
PKG_DIR = Path(__file__).resolve().parents[1] / PKG


def _imports(path: Path):
    """(target subpackage, is module level, line) of each import of the
    port inside one file."""
    tree = ast.parse(path.read_text())

    def walk(node, toplevel):
        for child in ast.iter_child_nodes(node):
            mods = []
            if isinstance(child, ast.Import):
                mods = [a.name for a in child.names]
            elif isinstance(child, ast.ImportFrom) and child.module:
                mods = [child.module]
            for m in mods:
                parts = m.split(".")
                if parts[0] == PKG and len(parts) > 1:
                    yield parts[1], toplevel, child.lineno
            inner = isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            yield from walk(child, toplevel and not inner)

    yield from walk(tree, True)


def _scan():
    """(subpackage, target, is module level, where) for every cross-package
    import of the port; top-level modules (``interop``, the package init)
    may import anything and are left out."""
    for f in sorted(PKG_DIR.rglob("*.py")):
        rel = f.relative_to(PKG_DIR)
        if len(rel.parts) == 1:
            continue
        sub = rel.parts[0]
        for target, toplevel, lineno in _imports(f):
            if target != sub:
                yield sub, target, toplevel, f"{PKG}/{rel}:{lineno}"


SUBPACKAGES = sorted(p.name for p in PKG_DIR.iterdir()
                     if p.is_dir() and (p / "__init__.py").exists())


def test_scan_sees_the_mission_stack():
    """The scan reaches the modules this contract matters for."""
    seen = {where.split(":")[0] for _, _, _, where in _scan()}
    for path in ("hardware/mission.py", "hardware/simulated_vehicle.py",
                 "planning/global_mission.py", "estimation/adapters.py"):
        assert f"{PKG}/{path}" in seen, path


def test_scan_sees_the_deployment():
    """The scan reaches the edge<->cloud deployment: the apps over comms."""
    seen = {where.split(":")[0] for _, _, _, where in _scan()}
    for path in ("apps/cloud.py", "apps/edge.py", "apps/autonomous.py",
                 "apps/minimal_takeoff.py", "comms/serializer.py",
                 "comms/zmq_transport.py", "comms/telemetry.py"):
        assert f"{PKG}/{path}" in seen, path
    assert {"apps", "comms"} <= set(SUBPACKAGES)
    assert (RANK["comms"], RANK["apps"]) == (3, 5)


def test_scan_sees_the_front_door():
    """The scan reaches the configuration and the apps that load it: the
    CLI and the web demo; ``config`` keeps the JAX package's rank 1."""
    seen = {where.split(":")[0] for _, _, _, where in _scan()}
    for path in ("config/frozen_config.py", "config/vehicle_params.py",
                 "config/airframe.py", "apps/cli.py",
                 "apps/web_demo.py", "common/di.py", "hardware/safety.py"):
        assert f"{PKG}/{path}" in seen, path
    assert "config" in SUBPACKAGES
    assert RANK["config"] == 1


NEW_MODULES = ("hardware/mavlink_adapter.py", "hardware/airsim_interface.py",
               "hardware/secure_interface.py", "gateway/middleware.py",
               "security/auth.py", "security/db.py", "security/key_manager.py",
               "security/credentials.py", "security/file_verification.py",
               "security/key_derivation.py", "security/os_keyring.py",
               "security/secure_files.py")


def test_scan_sees_the_adapters_security_and_gateway():
    """The scan reaches the last modules of the JAX package that import
    another subpackage: the hardware adapters, ``security/`` and
    ``gateway/``, which keeps the JAX package's rank 1, beside
    ``security``, and so may import it only inside a function."""
    seen = {where.split(":")[0] for _, _, _, where in _scan()}
    for path in NEW_MODULES:
        assert f"{PKG}/{path}" in seen, path
    assert "gateway" in SUBPACKAGES and RANK["gateway"] == RANK["security"] == 1
    gateway = [(target, toplevel) for sub, target, toplevel, _ in _scan() if sub == "gateway"]
    assert all(not toplevel for target, toplevel in gateway if target == "security")


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_module_level_layering(sub):
    violations = [
        f"{where}: {s} (rank {RANK[s]}) imports {target} (rank {RANK.get(target)}) "
        "at module level"
        for s, target, toplevel, where in _scan()
        if s == sub and toplevel and RANK.get(target, 99) >= RANK[s]
    ]
    assert not violations, "\n".join(violations)


@pytest.mark.parametrize("sub", sorted(CORE))
def test_core_never_touches_hardware_even_lazily(sub):
    violations = [
        f"{where}: {s} imports {target}"
        for s, target, _, where in _scan()
        if s == sub and target in FORBIDDEN_FOR_CORE
    ]
    assert not violations, "\n".join(violations)


def test_every_subpackage_has_a_rank():
    unranked = set(SUBPACKAGES) - set(RANK) - {"csrc"}
    assert not unranked, f"subpackages without a rank: {sorted(unranked)}"
