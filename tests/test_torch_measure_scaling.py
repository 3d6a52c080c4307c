"""scripts/measure_scaling_torch.py (the port's weak-scaling measurement) on
the CPU, against scripts/measure_scaling.py (the JAX package's).

``run_mesh`` starts the port's worker (``python -m
dart_planner_tpu_torch.parallel.worker --measure``) at 1 and 2 gloo
processes, one CPU device each, 8 scenarios a device and one rep: each
returns process 0's RESULT (each worker pinned to a core of its own, so
the file does not oversubscribe the CPU beside other workers), whose
``throughput`` carries the JAX script's
keys with a global batch of 8 per process and a positive, finite rate. The
table prints the JAX script's columns, and the efficiency of the first row
is 100.0%. ``--device cpu`` prints a row per process count up to
``--max-procs``. Without a card and without ``--device cpu`` the script
exits non-zero; with no more cards than processes it refuses the row.
"""

import contextlib
import importlib.util
import io
import math
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "measure_scaling_torch.py"
JAX_KEYS = ("processes", "devices", "global_batch", "solves_per_s", "solves_per_s_per_device")


def _load():
    spec = importlib.util.spec_from_file_location("measure_scaling_torch", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("processes", [1, 2])
def test_run_mesh_on_gloo_returns_the_jax_scripts_keys(processes):
    r = _load().run_mesh(processes, 1, 8, 1, pin_cores=True, backend="gloo")
    t = r["throughput"]
    assert set(JAX_KEYS) <= set(t)
    assert (t["processes"], t["devices"], t["global_batch"]) == (processes, processes,
                                                                 8 * processes)
    assert math.isfinite(t["solves_per_s"]) and t["solves_per_s"] > 0
    assert t["solves_per_s_per_device"] == pytest.approx(t["solves_per_s"] / processes)
    assert r["process_count"] == processes


def test_table_prints_the_jax_scripts_columns():
    rows = [{"processes": 1, "devices": 1, "global_batch": 8, "solves_per_s": 100.0,
             "solves_per_s_per_device": 100.0},
            {"processes": 2, "devices": 2, "global_batch": 16, "solves_per_s": 180.0,
             "solves_per_s_per_device": 90.0}]
    lines = _load().table(rows)
    assert lines[0] == ("| processes | devices | global batch | solves/s | "
                        "solves/s/device | efficiency |")
    assert lines[2:] == ["| 1 | 1 | 8 | 100 | 100 | 100.0% |",
                         "| 2 | 2 | 16 | 180 | 90 | 90.0% |"]


def test_cpu_main_prints_a_row_a_process_count():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = _load().main(["--device", "cpu", "--per-device", "8", "--max-procs", "1",
                             "--reps", "1", "--pin-cores"])
    printed = buf.getvalue()
    assert [r["processes"] for r in rows] == [1]
    assert "backend=gloo" in printed and "procs= 1 devices= 1 batch=    8" in printed
    assert "| 1 | 1 | 8 |" in printed and "100.0% |" in printed


def test_without_a_card_it_exits_non_zero():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script runs there")
    r = subprocess.run([sys.executable, str(SCRIPT), "--max-procs", "1"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "--device cpu" in r.stderr
    assert "procs=" not in r.stdout


def test_a_row_past_the_visible_cards_is_refused(monkeypatch):
    """One card: the NCCL row of one process runs (here a recorded stand-in
    for the worker), the row of two is refused with its reason."""
    script = _load()
    ran = []

    def run_mesh(n, local, per_device, reps, pin_cores=False, tail_iterations=0,
                 backend="nccl"):
        ran.append((n, local, backend))
        return {"throughput": {"processes": n, "devices": n, "global_batch": per_device * n,
                               "solves_per_s": 10.0, "solves_per_s_per_device": 10.0}}

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(script, "card_label", lambda device: "a card")
    monkeypatch.setattr(script, "run_mesh", run_mesh)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = script.main(["--max-procs", "4"])
    assert ran == [(1, 1, "nccl")] and len(rows) == 1
    assert "procs= 2 refused: 1 visible card(s)" in buf.getvalue()
