"""The long-horizon fleet shard (``fleet131k-n100``) and the open fleet
(``fleet131k-open``) through the harness: on the CPU at small sizes a sound
run is correct, and each work-skipping fault of the N=100 cell is caught
by the limit named for it; the pass of each B1 launch is read from the
program's counter, and the per-pass readers give their formulas. On the
card (``cuda``), a short run of each cell is correct and the TF32 control
of the N=100 cell is not."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark.drivers.replan_long import _PassLog
from benchmark.lib import harness
from benchmark.tests.test_bench_run import _newton_half, _newton_unchanged

LONG, OPEN = "fleet131k-n100", "fleet131k-open"
SMALL = {
    OPEN: ({"scenarios": 48, "check_replans": [3, 6]}, 2.0),
    # ~2 s a replan on one CPU thread: the window reaches replan 3
    LONG: ({"scenarios": 256, "check_replans": [2, 4]}, 8.0),
}


def run(cell, seed=2 ** 31 + 121):
    overrides, seconds = SMALL[cell]
    return harness.run_cell(cell, seed, seconds, False, "cpu", overrides)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", [LONG, OPEN])
def test_a_sound_small_run_is_correct(cell):
    r = run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    out = json.loads(harness.report(r)[1])
    assert set(out["metrics"]) == {m["name"] for m in harness.cell_spec(cell)["end_to_end"]}
    assert set(out["checks"]) == set(harness.cell_spec(cell)["config"]["limits"])


@pytest.mark.parametrize("fault,caught_by", [
    (_newton_unchanged, "excess_p50"),
    (_newton_half, "excess_mean"),
])
def test_a_work_skipping_fault_at_n100_is_not_correct(fault, caught_by, monkeypatch):
    fault(monkeypatch)
    r = run(LONG)
    assert not r["correct"]
    c = r["checks"][caught_by]
    assert c["value"] > c["limit"], r["checks"]


class _Library:
    def __init__(self):
        self.calls = 0

    def mpc_solve_launch(self, *args):
        self.calls += 1
        return 0

    def mpc_scratch_floats(self, params):
        return 0


def test_the_pass_of_each_launch_is_read_from_the_counter():
    """Each launch through the log is given the series of ``b1_launches``
    that rose before the next launch (or the last settle); a launch under
    which no series rose, or several did, reads None."""
    from dart_planner_tpu_torch.common.metrics import MetricsManager

    m, lib = MetricsManager(), _Library()
    log = _PassLog(m, lib)
    arm = {"steps": 4, "arena": "shared"}
    for p in ("phase1", "tail", "phase1", None, "tail"):
        assert log.mpc_solve_launch(1, 2) == 0
        if p is not None:
            m.increment("b1_launches", labels={"pass": p, **arm})
    log.settle()
    assert lib.calls == 5 and log.mpc_scratch_floats(None) == 0
    assert [None if x is None else x["pass"] for x in log.passes] == [
        "phase1", "tail", "phase1", None, "tail"]
    assert log.passes[0] == {"pass": "phase1", "steps": "4", "arena": "shared"}


@pytest.mark.parametrize("name,key", [("b1_phase1_roofline.long", "phase1"),
                                      ("b1_tail_roofline.long", "tail")])
def test_the_per_pass_readers_give_their_formulas(name, key):
    reader = harness.load_metric(name)
    other = "tail" if key == "phase1" else "phase1"
    ctx = {"b1_pass": {key: {"device_ms": 400.0, "launches": 4, "bound_ms": 36.0},
                       other: {"device_ms": 1.0, "launches": 1, "bound_ms": 1.0}}}
    assert reader.read(ctx) == pytest.approx(9.0, rel=1e-12)
    assert reader.read({"b1_pass": {other: ctx["b1_pass"][other]}}) is None
    assert reader.read({}) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [LONG, OPEN])
def test_a_short_run_on_the_card(cell, card):
    r = harness.run_cell(cell, 2 ** 31 + 21, 3.0, False, card, {"check_replans": [3, 6]})
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["memory_peak_bytes"] > 0


@pytest.mark.cuda
def test_the_control_at_n100_is_not_correct(card):
    """The reference in the program's place with its products in TF32 fails
    the N=100 cell's comparison, at a small size."""
    from benchmark import control
    from dart_planner_tpu_torch.ops import cuda_rollout
    from dart_planner_tpu_torch.planning import se3_mpc

    saved = [(m, n, getattr(m, n)) for m, n in (
        (se3_mpc, "solve"), (se3_mpc, "extract_trajectory"),
        (cuda_rollout, "setpoints_from_plan"), (cuda_rollout, "run_tick_block"))]
    try:
        control.put_reference_in_place(harness.cell_spec(LONG)["config"])
        r = harness.run_cell(LONG, 2 ** 31 + 23, 4.0, False, card,
                             {"scenarios": 4096, "check_replans": [3, 6]})
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)
    assert not r["correct"], r["checks"]
