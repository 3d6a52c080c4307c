#!/usr/bin/env python3
"""The PyTorch port's benchmark (the port's counterpart of bench.py, which
imports JAX and stays): batched SE(3) MPC throughput (solves/s, N=20) and
the four sections beside it, on the card through kernels B1 and B2.

    python bench_torch.py                              # the card
    python -m dart_planner_tpu_torch.apps.cli bench    # the same, through the CLI
    python bench_torch.py --device cpu                 # the plain paths, host clock

Five sections in bench.py's order, at its sizes and under its field names:

1. ``throughput``: the shipping two-phase solve (``SE3MPCConfig()``) and the
   phase-1 solve (``tail_iterations=0``) of 4096 scenarios (4 spheres a
   scenario padded to 8), 3 interleaved passes of 30 chained solves each,
   the fastest pass of each; ``value`` is two-phase solves/s and
   ``vs_baseline`` its ratio to 1000 solves/s (BASELINE.md);
2. ``single``: one scenario, 100 chained solves, the fastest of 3 passes;
3. ``fastpath``: ``PlannerFastPath`` handing 150 replans to the 400 Hz
   ``create_control_loop``, gated as the reference's CI gates it: p95 of
   planning < 50 ms, of a control tick < 5 ms, of the two < 50 ms;
4. ``fleet``: 131,072 scenarios, 6 chained solves, the fastest of 2 passes;
5. ``mc``: the closed-loop Monte-Carlo of 2048 episodes (60 replans of 40
   control ticks) on mapper-perceived sphere worlds, with wind, sensor
   noise, in-flight sensing and the unknown-space speed cap: 3 timed runs
   after a warm-up, and the fleet's success, crash, tracking RMSE and
   obstacle clearance.

The solve problems are bench.py's numpy draws from ``--seed`` in bench.py's
order, so seed 0 gives the JAX bench's problems. The Monte-Carlo's fleet,
worlds, perception, wind and sensor noise are drawn once, before any timed
run, from a CPU ``torch.Generator`` seeded ``--seed``
(scripts/diag_timeouts_torch.py's ``build_fleet``): ``jax.random``'s draws
cannot be reproduced in torch, so they are a fresh sample of the JAX bench's.

A chained pass (each solve's thrusts warm-start the next) is timed as a
user calls it: CUDA events around the whole chain after a synchronise.
Each section counts the launches of both kernels it makes (warm-ups
included) per solve, replan or run. Every time stands beside the card's
name and power limit as nvidia-smi gives them (``card``); on the CPU the
times are the host clock's and no gate is checked.

After every section the cumulative record is printed as one JSON line and
mirrored to ``BENCH_TORCH_PARTIAL.json``; the last line printed is the most
complete. A section that raises, a section skipped or cut off by the
``--budget-s`` budget (``"truncated": true``) or a failed latency gate
prints the record and then ends the run non-zero. Without a card it exits
non-zero unless ``--device cpu`` is given. Imports the port only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dart_planner_tpu_torch.common.device import card_label  # noqa: E402
from dart_planner_tpu_torch.ops import cuda_mpc, cuda_rollout  # noqa: E402
from dart_planner_tpu_torch.planning import se3_mpc  # noqa: E402

from diag_convergence_torch import script_device, timed  # noqa: E402
from diag_timeouts_torch import Fleet, base_config, build_fleet, fly  # noqa: E402

PARTIAL = os.path.join(ROOT, "BENCH_TORCH_PARTIAL.json")
SECTIONS = ("throughput", "single", "fastpath", "fleet", "mc")
BASELINE_SOLVES_PER_S = 1000.0  # the north-star target (BASELINE.md)
SINGLE_SOLVE_BUDGET_MS = 50.0
# the reference's CI latency gates (tests/test_real_time_latency.py:109-120)
LATENCY_GATES_MS = {"planning_host_p95_ms": 50.0, "control_tick_p95_ms": 5.0,
                    "planner_to_actuator_p95_ms": 50.0}
RT_GAINS = dict(kp_pos=[7.0, 7.0, 8.5], ki_pos=[0.5] * 3, kd_pos=[4.0] * 3,
                kp_att=[10.0] * 3, ki_att=[0.1] * 3, kd_att=[1.0] * 3)
# a section does not start with less of the budget left than this
SECTION_MIN_S = 15.0


class Report:
    """The cumulative record and the budget's watchdog.

    Every ``update`` and ``error`` prints the whole record as one JSON line
    and mirrors it to ``path``. When the budget runs out inside a section,
    the watchdog marks the record truncated, prints it and ends the process
    with exit code 1: the main thread may be blocked in the card's code."""

    def __init__(self, budget_s: float, path: str, **fields):
        self.t0 = time.monotonic()
        self.budget = budget_s
        self.path = path
        self.lock = threading.Lock()
        self.section = None
        self.data = {
            "metric": "batched SE(3) MPC throughput (N=20, 4096 scenarios)",
            "value": None,
            "unit": "solves/s/chip",
            "vs_baseline": None,
            "sections": [],
            "truncated": False,
            **fields,
        }
        self._watchdog = threading.Timer(budget_s, self._on_deadline)
        self._watchdog.daemon = True
        self._watchdog.start()

    def remaining(self) -> float:
        return self.budget - (time.monotonic() - self.t0)

    def update(self, section: str, fields: dict) -> None:
        with self.lock:
            self.data.update(fields)
            self.data["sections"].append(section)
            self.dump()

    def error(self, section: str, message: str) -> None:
        with self.lock:
            self.data.setdefault("section_errors", []).append(f"{section}: {message}"[:200])
            self.dump()

    def dump(self) -> None:
        self.data["elapsed_s"] = round(time.monotonic() - self.t0, 1)
        line = json.dumps(self.data)
        try:
            with open(self.path, "w") as f:
                f.write(line + "\n")
        except OSError:
            pass
        print(line, flush=True)

    def _on_deadline(self) -> None:
        with self.lock:
            self.data["truncated"] = True
            self.data.setdefault("section_errors", []).append(
                f"{self.section}: cut off: the budget of {self.budget} s ran out")
            self.dump()
        print(f"bench: the budget of {self.budget} s ran out in section {self.section}",
              file=sys.stderr, flush=True)
        os._exit(1)

    def finish(self) -> None:
        self._watchdog.cancel()


def bench_problem(rng: np.random.Generator, batch: int, config: se3_mpc.SE3MPCConfig,
                  device):
    """bench.py's problem (its ``problem`` closure, :148-162): 4 spheres a
    scenario, random start, velocity and goal, drawn from ``rng`` in its
    order, on ``device``."""
    obs = np.concatenate(
        [rng.normal(0, 4, (batch, 4, 3)), rng.uniform(0.3, 1.2, (batch, 4, 1))], axis=-1,
    ).astype(np.float32)
    return se3_mpc.make_problem(
        rng.normal(0, 2, (batch, 3)).astype(np.float32) + [0, 0, 5],
        rng.normal(0, 1, (batch, 3)).astype(np.float32),
        rng.normal(0, 5, (batch, 3)).astype(np.float32) + [0, 0, 5],
        obstacles=obs, config=config, device=device,
    )


def _launches() -> np.ndarray:
    return np.array([cuda_mpc.LAUNCHES, cuda_rollout.LAUNCHES])


def _per(counts: np.ndarray, n: int) -> dict:
    """Launches of B1 and B2 per unit of work, over ``n`` units."""
    return {"B1": float(counts[0]) / n, "B2": float(counts[1]) / n}


def chained(config, prob, u, reps: int, device) -> tuple:
    """``reps`` solves, each warm-started from the last one's thrusts, timed
    as one chain after a synchronise: (s per solve, the last thrusts)."""
    def chain():
        v = u
        for _ in range(reps):
            v = se3_mpc.solve(config, prob, v).thrusts
        return v

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    u, ms = timed(chain, device)
    return ms / 1e3 / reps, u


def best_chains(configs, prob, reps: int, passes: int, device) -> list:
    """For each config: a warm-up solve from the cold start, then the
    fastest of ``passes`` chains of ``reps`` solves, the configs' passes
    interleaved so they share the card's weather. Returns, per config, (s
    per solve, launches per solve, the warm-up's included)."""
    u0 = se3_mpc.initialize_thrusts(configs[0], prob)
    us, best, counts = [], [float("inf")] * len(configs), [0] * len(configs)
    for i, config in enumerate(configs):
        before = _launches()
        us.append(se3_mpc.solve(config, prob, u0).thrusts)
        counts[i] = _launches() - before
    for _ in range(passes):
        for i, config in enumerate(configs):
            before = _launches()
            t, us[i] = chained(config, prob, us[i], reps, device)
            counts[i] = counts[i] + _launches() - before
            best[i] = min(best[i], t)
    return [(t, _per(n, 1 + reps * passes)) for t, n in zip(best, counts)]


def section_throughput(device, rng, batch: int = 4096, reps: int = 30,
                       passes: int = 3) -> dict:
    """The shipping two-phase solve and the phase-1 solve of ``batch``
    scenarios: the fastest of ``passes`` interleaved passes of ``reps``
    chained solves each."""
    device = torch.device(device)
    config = se3_mpc.SE3MPCConfig()
    (per_call, per), (per_call_p1, per_p1) = best_chains(
        (config, config._replace(tail_iterations=0)), bench_problem(rng, batch, config, device),
        reps, passes, device)
    return {
        "value": round(batch / per_call, 1),
        "vs_baseline": round(batch / per_call / BASELINE_SOLVES_PER_S, 3),
        "phase1_solves_per_s": round(batch / per_call_p1, 1),
        "batch_step_ms": round(per_call * 1e3, 3),
        "device": device.type,
        "launches_per_solve": per,
        "phase1_launches_per_solve": per_p1,
    }


def section_single(device, rng, reps: int = 100, passes: int = 3) -> dict:
    """One scenario, the fastest of ``passes`` chains of ``reps`` solves."""
    device = torch.device(device)
    config = se3_mpc.SE3MPCConfig()
    [(lat_s, per)] = best_chains((config,), bench_problem(rng, 1, config, device), reps,
                                 passes, device)
    return {"single_solve_device_ms": round(lat_s * 1e3, 4),
            "single_solve_budget_ms": SINGLE_SOLVE_BUDGET_MS,
            "single_launches_per_solve": per}


def gate_failures(fields: dict) -> list:
    """The latency gates a fast-path record fails, as text."""
    return [f"{k}={fields[k]:.3f} >= {lim}" for k, lim in LATENCY_GATES_MS.items()
            if fields[k] >= lim]


def section_fastpath(device, replans: int = 150) -> dict:
    """The planner-to-actuator path: ``measure_latency`` of
    ``PlannerFastPath(SE3MPCConfig())`` handing ``replans`` replans (after
    one warm-up) to the running 400 Hz control loop. ``latency_gate_ok`` is
    None on the CPU, where no gate is checked."""
    from dart_planner_tpu_torch.runtime import rt_executor
    from dart_planner_tpu_torch.runtime.fast_path import PlannerFastPath, measure_latency

    device = torch.device(device)
    fp = PlannerFastPath(se3_mpc.SE3MPCConfig(), device=device)
    loop = rt_executor.create_control_loop(frequency_hz=400.0)
    loop.set_gains(**RT_GAINS)
    before = _launches()
    loop.start()
    try:
        rt = measure_latency(fp, loop, n_replans=replans)
    finally:
        loop.stop()
    fields = {
        "planner_to_actuator_p95_ms": round(rt["planner_to_actuator_p95_ms"], 3),
        "planning_host_p95_ms": round(rt["planning_host_p95_ms"], 3),
        "control_tick_p95_ms": round(rt["control_tick_p95_ms"], 4),
        "rt_loop": type(loop).__name__,
        "fastpath_launches_per_replan": _per(_launches() - before, replans + 1),
    }
    fields["latency_gate_ok"] = (not gate_failures(fields)) if device.type == "cuda" else None
    return fields


def section_fleet(device, rng, batch: int = 131_072, reps: int = 6, passes: int = 2) -> dict:
    """The fleet shard (BASELINE config 5): the fastest of ``passes`` chains
    of ``reps`` solves of ``batch`` scenarios, the problem and its cold
    start built outside the timed window."""
    device = torch.device(device)
    config = se3_mpc.SE3MPCConfig()
    [(per_solve, per)] = best_chains((config,), bench_problem(rng, batch, config, device),
                                     reps, passes, device)
    return {f"fleet_{batch}_solves_per_s": round(batch / per_solve, 1),
            "fleet_launches_per_solve": per}


def section_mc(device, seed: int = 0, episodes: int = 2048, runs: int = 3, warmups: int = 1,
               fleet: Fleet = None) -> dict:
    """The closed-loop Monte-Carlo (BASELINE config 4) at the JAX bench's
    ``ClosedLoopConfig`` from START to GOAL of scripts/diag_timeouts_torch.py
    ((0, 0, 3) to (6, 3, 4)): ``warmups`` runs, then the fastest of ``runs``
    timed runs, each ending in a synchronise. ``fleet`` replaces the draws
    from ``seed``."""
    device = torch.device(device)
    config = base_config()
    if fleet is None:
        fleet = build_fleet(episodes, seed, device, config, max_replans=config.num_replans)
    n = fleet.goals.shape[0]
    before = _launches()
    for _ in range(warmups):
        fly(config, fleet)
    best = float("inf")
    for _ in range(runs):
        res, ms = fly(config, fleet)
        best = min(best, ms / 1e3)
    return {
        "closed_loop_episodes_per_s": round(n / best, 1),
        "mc_success_rate": round(float(res.success.float().mean()), 4),
        "mc_crash_rate": round(float(res.crashed.float().mean()), 4),
        "tracking_rmse_m": round(float(res.tracking_rmse.mean()), 4),
        "mean_min_obstacle_clearance_m": round(float(res.min_obstacle_clearance.mean()), 3),
        "mc_launches_per_run": _per(_launches() - before, warmups + runs),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="the device to run on (default cuda; cpu runs the plain paths)")
    ap.add_argument("--seed", type=int, default=0,
                    help="the seed of the problems' numpy draws and the fleet's generator")
    ap.add_argument("--budget-s", type=float, default=480.0,
                    help="wall-clock budget of the run, s; past it the run ends non-zero")
    args = ap.parse_args(argv)
    device = script_device(ap, args.device)
    rep = Report(args.budget_s, PARTIAL, card=card_label(device), seed=args.seed)
    rng = np.random.default_rng(args.seed)
    sections = {
        "throughput": lambda: section_throughput(device, rng),
        "single": lambda: section_single(device, rng),
        "fastpath": lambda: section_fastpath(device),
        "fleet": lambda: section_fleet(device, rng),
        "mc": lambda: section_mc(device, args.seed),
    }
    try:
        for name in SECTIONS:
            if rep.remaining() < SECTION_MIN_S:
                with rep.lock:
                    rep.data["truncated"] = True
                rep.error(name, "skipped: the budget is spent")
                continue
            rep.section = name
            try:
                fields = sections[name]()
            except Exception as e:  # one section's failure is recorded; the run fails
                traceback.print_exc()
                rep.error(name, f"{type(e).__name__}: {e}")
                continue
            rep.update(name, fields)
        with rep.lock:
            rep.data["launches"] = dict(zip(("B1", "B2"), _launches().tolist()))
            rep.dump()  # the final, most complete line is the last printed
    finally:
        rep.finish()
    failures = list(rep.data.get("section_errors", []))
    if rep.data.get("latency_gate_ok") is False:
        failures += [f"latency gate: {g}" for g in gate_failures(rep.data)]
    if failures or rep.data["truncated"]:
        print("BENCH FAILED: " + "; ".join(failures or ["truncated"]), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
