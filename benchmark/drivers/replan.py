"""Driver of a fleet shard: one caller replanning the whole batch back to
back, a closed loop. A replan is ``make_problem`` from the vehicles'
current states, ``solve`` warm-started by ``shift_warm_start`` of the last
replan's thrusts, and ``extract_trajectory``, synchronised; the states
cycle through the traffic's pool, one set a replan.

End-to-end: ``solves_per_s`` (the scenarios of every replan completed in
the window over the window's seconds) and ``replan_p95_ms`` (the 95th
percentile over every replan in the window of its host-clock time from
start to synchronised plan).

Correctness: the full outputs of two replans drawn from the seed (and the
thrusts of the replan before each) are copied into buffers made in set-up,
then held against ``benchmark/reference`` after the window.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.lib import roofline
from benchmark.lib.trace import KernelEvents, Spans
from benchmark.reference import checks
from benchmark.reference.solve import SolverConfig

RECORDED = 2  # replans whose outputs the check compares


class Cell:
    def __init__(self, config: dict, traffic: dict, inputs: dict, seed: int, device,
                 trace: bool):
        from dart_planner_tpu_torch.planning import se3_mpc

        self.se3_mpc = se3_mpc
        self.inp = inputs
        self.device = torch.device(device)
        self.cfg = se3_mpc.SE3MPCConfig(**{k: tuple(v) if isinstance(v, list) else v
                                           for k, v in config["solver"].items()})
        self.ref_cfg = SolverConfig.from_dict(config["solver"])
        self.B = int(config["scenarios"])
        self.pool = inputs["positions"].shape[0]
        rng = np.random.default_rng(seed % (2 ** 63))
        lo, hi = config["check_replans"]  # drawn from, counted from set-up's first
        self.record_at = sorted(rng.choice(np.arange(lo, hi), RECORDED, replace=False).tolist())
        self.spans = Spans()
        self.events = KernelEvents() if trace and self.device.type == "cuda" else None
        self.i = 0  # replans run so far, set-up's included
        self.u = None
        self.records = []

    def _buffers(self):
        N = self.cfg.prediction_horizon
        kw = dict(dtype=torch.float32, device=self.device)
        B = self.B
        return {"u_prev": torch.empty((B, N, 3), **kw), "thrusts": torch.empty((B, N, 3), **kw),
                "positions": torch.empty((B, N, 3), **kw),
                "velocities": torch.empty((B, N, 3), **kw),
                "accelerations": torch.empty((B, N, 3), **kw),
                "cost": torch.empty((B,), **kw),
                "converged": torch.empty((B,), dtype=torch.bool, device=self.device),
                "attitudes": torch.empty((B, N, 3), **kw),
                "body_rates": torch.empty((B, N, 3), **kw),
                "thrust_norms": torch.empty((B, N), **kw), "timestamps": torch.empty((B, N), **kw)}

    def replan(self) -> float:
        """One replan; returns its host-clock seconds."""
        m, inp, sp = self.se3_mpc, self.inp, self.spans
        k = self.i % self.pool
        t0 = time.perf_counter()
        with sp.span("replan.make_problem"):
            prob = m.make_problem(inp["positions"][k], inp["velocities"][k], inp["goal"],
                                  obstacles=inp["obstacles"], config=self.cfg)
        with sp.span("replan.solve"):
            u0 = None if self.u is None else m.shift_warm_start(self.cfg, self.u)
            res = m.solve(self.cfg, prob, u0)
        with sp.span("replan.extract"):
            traj = m.extract_trajectory(self.cfg, res, inp["timestamps"][k])
        if self.i in self.record_at:
            buf = self.records[self.record_at.index(self.i)]
            buf["k"] = k
            for name, src in (("u_prev", self.u), ("thrusts", res.thrusts),
                              ("positions", res.positions), ("velocities", res.velocities),
                              ("accelerations", res.accelerations), ("cost", res.cost),
                              ("converged", res.converged), ("attitudes", traj.attitudes),
                              ("body_rates", traj.body_rates), ("thrust_norms", traj.thrusts),
                              ("timestamps", traj.timestamps)):
                buf[name].copy_(src)
        with sp.span("replan.sync"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.u = res.thrusts
        self.i += 1
        return time.perf_counter() - t0

    def setup(self) -> None:
        """The record buffers; the event timers in a traced run; two
        replans, the first from the cold start, the second warm-started as
        every replan of the window is."""
        self.records = [self._buffers() for _ in range(RECORDED)]
        if self.events is not None:
            from dart_planner_tpu_torch.ops import cuda_mpc

            self.events.install("B1", cuda_mpc, "mpc_solve_launch")
        self.replan()
        self.replan()

    def window(self, seconds: float) -> dict:
        """Replans back to back until ``seconds`` have passed."""
        mark = self.events.mark("B1") if self.events else 0
        self.spans.spans.clear()
        walls = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            walls.append(self.replan())
        span = time.perf_counter() - t0
        n = len(walls)
        if self.i <= self.record_at[-1]:
            raise RuntimeError(f"the window ran {n} replans, too few to reach replan "
                               f"{self.record_at[-1]} for the check")
        self.walls, self.b1_mark = walls, mark
        return {"solves_per_s": self.B * n / span,
                "replan_p95_ms": 1e3 * float(np.quantile(walls, 0.95)),
                "attempted": n, "failed": 0}

    def layers(self) -> dict:
        """The traced window's ingredients of the per-layer metrics."""
        ctx = {"replans": len(self.walls), "replan_ms": 1e3 * float(np.mean(self.walls)),
               "spans": {k: list(v) for k, v in self.spans.spans.items()}}
        if self.events is not None:
            ms = self.events.ms("B1", self.b1_mark)
            pr = self.inp["obstacles"].shape[1]
            bound = roofline.solve_bound_ms(self.ref_cfg, self.B, pr,
                                            self.cfg.max_obstacles, False)
            ctx["b1"] = {"device_ms": sum(ms), "launches": len(ms),
                         "bound_ms": bound * len(self.walls)}
        return ctx

    def profiled(self, replans: int = 16) -> None:
        """A steady stretch of replans for the profiler."""
        for _ in range(replans):
            self.replan()

    def release(self) -> None:
        """Free the program's state; the records stay."""
        if self.events is not None:
            self.events.uninstall()
        self.u = None

    def check(self) -> dict:
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return checks.fleet(self.ref_cfg, self.inp, self.records)

