"""Whole runs of the harness: on the CPU at small sizes, a sound run is
correct and a run with the timed path broken underneath is not, for each
fault a cell can have; the result line's keys; no result without a card.
On the card (``cuda``), one short run of each cell and the control."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark.lib import harness

FLEET, MC = "fleet131k-spheres", "mc16k-perceived"
MC_CONFIG = json.loads((harness.HERE / "configs/mc_fleet.json").read_text())
SMALL = {
    FLEET: ({"scenarios": 48, "check_replans": [3, 6]}, 2.0),
    # the plain solve parts from itself at line-search ties on some 7% of
    # these problems on the CPU, so the MC's excess quantile wants a hundred
    # or more of them
    MC: ({"episodes": 64, "method": "fused", "check_sample": 4096,
          "loop": dict(MC_CONFIG["loop"], num_replans=2)}, 0.3),
}


def run(cell, seed=2 ** 31 + 77, trace=False):
    overrides, seconds = SMALL[cell]
    return harness.run_cell(cell, seed, seconds, trace, "cpu", overrides)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", [FLEET, MC])
def test_a_sound_small_run_is_correct(cell):
    r = run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    tail, line = harness.report(r)
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(out["metrics"]) == {m["name"] for m in harness.cell_spec(cell)["end_to_end"]}
    assert set(out["checks"]) == set(harness.cell_spec(cell)["config"]["limits"])
    assert tail.splitlines() == [f"check {k} = {c['value']!r} (limit {c['limit']!r})"
                                 for k, c in out["checks"].items()]


def test_a_traced_small_run_reports_per_layer_metrics_and_no_end_to_end_ones():
    r = run(MC, trace=True)
    names = {m["name"] for m in harness.cell_spec(MC)["per_layer"]}
    assert set(r["metrics"]) <= names and "loop_host_ms.mc" in r["metrics"]
    assert r["correct"]


def _newton_unchanged(monkeypatch):
    from dart_planner_tpu_torch.planning import se3_mpc

    monkeypatch.setattr(se3_mpc, "_newton_iterate",
                        lambda config, prob, u, use: (u, torch.zeros(u.shape[:-2])))


def _newton_half(monkeypatch):
    from dart_planner_tpu_torch.planning import se3_mpc

    original = se3_mpc._newton_iterate

    def half(config, prob, u, use):
        n = u.shape[0] // 2
        part = type(prob)(*[None if x is None else x[:n] for x in prob])
        u_half, imp = original(config, part, u[:n], use)
        return torch.cat([u_half, u[n:]]), torch.cat([imp, torch.zeros(u.shape[0] - n)])

    monkeypatch.setattr(se3_mpc, "_newton_iterate", half)


def _plan_altered(monkeypatch):
    from dart_planner_tpu_torch.planning import se3_mpc

    original = se3_mpc._finalize

    def altered(*args, **kwargs):
        res = original(*args, **kwargs)
        pos = res.positions.clone()
        pos[0, 5] += 0.01
        return res._replace(positions=pos)

    monkeypatch.setattr(se3_mpc, "_finalize", altered)


def _ticks_unchanged(monkeypatch):
    from dart_planner_tpu_torch.ops import cuda_rollout

    original = cuda_rollout.run_tick_block_plain

    def unchanged(*args):
        return args[5], original(*args)[1]

    monkeypatch.setattr(cuda_rollout, "run_tick_block_plain", unchanged)


def _ticks_half(monkeypatch):
    from dart_planner_tpu_torch.ops import cuda_rollout

    original = cuda_rollout.run_tick_block_plain

    def half(*args):
        S, acc = original(*args)
        n = S.shape[1] // 2
        return torch.cat([S[:, :n], args[5][:, n:]], dim=1), acc

    monkeypatch.setattr(cuda_rollout, "run_tick_block_plain", half)


def _outcome_altered(monkeypatch):
    from dart_planner_tpu_torch.sim import closed_loop

    original = closed_loop.simulate_episode

    def altered(*args, **kwargs):
        res = original(*args, **kwargs)
        crashed = res.crashed.clone()
        crashed[0] = ~crashed[0]
        return res._replace(crashed=crashed)

    monkeypatch.setattr(closed_loop, "simulate_episode", altered)


@pytest.mark.parametrize("cell,fault,caught_by", [
    (FLEET, _newton_unchanged, "excess_p90"),
    (FLEET, _newton_half, "excess_p90"),
    (FLEET, _plan_altered, "state_gap"),
    (MC, _newton_unchanged, "plan_excess_p90"),
    (MC, _ticks_unchanged, "tick_gap"),
    (MC, _ticks_half, "tick_gap"),
    (MC, _outcome_altered, "tick_gap"),
])
def test_a_broken_timed_path_is_not_correct(cell, fault, caught_by, monkeypatch):
    fault(monkeypatch)
    r = run(cell)
    assert not r["correct"]
    c = r["checks"][caught_by]
    assert c["value"] > c["limit"], r["checks"]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", FLEET, "--seed",
                          "1", "--seconds", "1", "--trace", "0"], cwd=harness.ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [FLEET, MC])
def test_a_short_run_on_the_card(cell, card):
    r = harness.run_cell(cell, 2 ** 31 + 5, 3.0, False, card)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["memory_peak_bytes"] > 0


@pytest.mark.cuda
def test_the_control_is_not_correct(card):
    """The reference in the program's place with its products in TF32 fails
    the comparison, at a small size."""
    from benchmark import control
    from dart_planner_tpu_torch.ops import cuda_rollout
    from dart_planner_tpu_torch.planning import se3_mpc

    saved = [(m, n, getattr(m, n)) for m, n in (
        (se3_mpc, "solve"), (se3_mpc, "extract_trajectory"),
        (cuda_rollout, "setpoints_from_plan"), (cuda_rollout, "run_tick_block"))]
    try:
        control.put_reference_in_place(harness.cell_spec(FLEET)["config"])
        r = harness.run_cell(FLEET, 2 ** 31 + 9, 4.0, False, card,
                             {"scenarios": 4096, "check_replans": [3, 6]})
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)
    assert not r["correct"], r["checks"]
