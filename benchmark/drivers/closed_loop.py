"""Driver of a closed-loop Monte-Carlo fleet: whole runs of
``simulate_episode`` over every episode, back to back. One run is the
whole fleet's episodes: at each 10 Hz replan the solve, the setpoints and
the tick block of the 400 Hz controller and plant, and the loop's glue
between them.

End-to-end: ``episodes_per_s`` (the episodes of every whole run completed
in the window, over the time from the first run's start to the last one's
end).

Correctness: the benchmark's wrappers around the program's
``se3_mpc.solve``, ``cuda_rollout.setpoints_from_plan`` and
``cuda_rollout.run_tick_block`` keep references to what each call of a run
received and returned (no copy, no device work); the last run's are held
against ``benchmark/reference`` after the window, on a sample of episodes
drawn from the seed, and its outcome on every episode.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.lib import roofline
from benchmark.lib.trace import KernelEvents, Spans
from benchmark.reference import checks
from benchmark.reference.solve import SolverConfig

OUTCOME = ("final_position", "final_distance", "min_distance", "tracking_rmse",
           "min_obstacle_clearance", "crashed", "success")


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


class Cell:
    def __init__(self, config: dict, traffic: dict, inputs: dict, seed: int, device,
                 trace: bool):
        from dart_planner_tpu_torch.common.types import DroneState
        from dart_planner_tpu_torch.control.geometric import GeometricConfig
        from dart_planner_tpu_torch.ops import cuda_rollout
        from dart_planner_tpu_torch.planning import se3_mpc
        from dart_planner_tpu_torch.sim import closed_loop, physics

        self.se3_mpc, self.cuda_rollout, self.closed_loop = se3_mpc, cuda_rollout, closed_loop
        self.config, self.inp = config, inputs
        self.device = torch.device(device)
        lp = config["loop"]
        self.mpc = se3_mpc.SE3MPCConfig(**_tuples(config["solver"]))
        self.loop = closed_loop.ClosedLoopConfig(
            mpc=self.mpc, physics=physics.PhysicsConfig(**_tuples(config["plant"])),
            control=GeometricConfig(**_tuples(config["controller"])),
            **{k: v for k, v in lp.items() if k in closed_loop.ClosedLoopConfig._fields})
        self.ref_cfg = SolverConfig.from_dict(config["solver"])
        self.method = config.get("method", "auto")
        n = inputs["goals"].shape[0]
        self.states = DroneState.zeros((n,), dtype=torch.float32, device=self.device).replace(
            position=inputs["starts"])
        rng = np.random.default_rng(seed % (2 ** 63))
        sample = min(n, int(config["check_sample"]))
        self.rows = torch.as_tensor(np.sort(rng.choice(n, sample, replace=False)),
                                    device=self.device)
        self.spans = Spans()
        self.events = KernelEvents() if trace and self.device.type == "cuda" else None
        self.blocks: list = []
        self.result = None
        self._originals = []
        self.missing: list[str] = []  # calls of the program that are gone

    # -- the wrappers around the program's three calls of a replan --------
    def _wrap(self, module, name: str, span: str, record):
        original = getattr(module, name, None)
        if original is None:
            self.missing.append(f"{module.__name__}.{name}")
            return
        spans = self.spans

        def wrapped(*args, **kwargs):
            with spans.span(span):
                out = original(*args, **kwargs)
            record(args, kwargs, out)
            return out

        setattr(module, name, wrapped)
        self._originals.append((module, name, original))

    def _on_solve(self, args, kwargs, res):
        prob = args[1]
        u0 = args[2] if len(args) > 2 else kwargs.get("u_init")
        self.blocks.append({
            "p0": prob.p0, "v0": prob.v0, "obstacles": prob.obstacles,
            "mask": prob.obstacle_mask, "v_cap": prob.v_cap, "u_init": u0,
            "thrusts": res.thrusts, "positions": res.positions, "velocities": res.velocities,
            "accelerations": res.accelerations, "cost": res.cost})

    def _on_setpoints(self, args, kwargs, out):
        if self.blocks:
            self.blocks[-1].update(zip(("spp", "spv", "spa"), out))

    def _on_ticks(self, args, kwargs, out):
        if self.blocks:
            self.blocks[-1].update(S_in=args[5], gw=args[9], obs_rows=args[10], S_out=out[0],
                                   acc=out[1])

    def install(self) -> None:
        self._wrap(self.se3_mpc, "solve", "mc.solve", self._on_solve)
        self._wrap(self.cuda_rollout, "setpoints_from_plan", "mc.setpoints", self._on_setpoints)
        self._wrap(self.cuda_rollout, "run_tick_block", "mc.tick_block", self._on_ticks)

    def release(self) -> None:
        """Restore the program's functions and free its state; the last
        run's records stay."""
        for module, name, original in reversed(self._originals):
            setattr(module, name, original)
        self._originals.clear()
        if self.events is not None:
            self.events.uninstall()

    # -- runs --------------------------------------------------------------
    def run(self) -> None:
        """One whole run of the fleet, synchronised."""
        inp = self.inp
        self.blocks = []
        with self.spans.span("mc.loop"):
            res = self.closed_loop.simulate_episode(
                self.loop, None, self.states, inp["goals"], obstacles=inp["obstacles"],
                obstacle_mask=inp["mask"], method=self.method,
                true_obstacles=inp["true_obstacles"], true_obstacle_mask=inp["true_mask"],
                corridor_observed=inp["corridor"], wind=inp["wind"], noise=inp["noise"])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.result = res

    def setup(self) -> None:
        """The wrappers, the event timers in a traced run, one run."""
        self.install()
        if self.events is not None:
            from dart_planner_tpu_torch.ops import cuda_mpc, cuda_rollout

            self.events.install("B1", cuda_mpc, "mpc_solve_launch")
            self.events.install("B2", cuda_rollout, "tick_block_launch")
        self.run()

    def window(self, seconds: float) -> dict:
        marks = {k: self.events.mark(k) for k in ("B1", "B2")} if self.events else {}
        self.spans.spans.clear()
        runs = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.run()
            runs += 1
        span = time.perf_counter() - t0
        n = int(self.inp["goals"].shape[0])
        self.runs, self.marks = runs, marks
        return {"episodes_per_s": n * runs / span, "attempted": n * runs, "failed": 0}

    def layers(self) -> dict:
        """The traced window's ingredients of the per-layer metrics."""
        sp = self.spans
        replans = self.runs * int(self.loop.num_replans)
        ctx = {"runs": self.runs, "replans": replans,
               "spans": {k: list(v) for k, v in sp.spans.items()}, "missing_hooks": self.missing}
        if not self.missing:
            ctx["loop_host_ms"] = 1e3 * (sp.total("mc.loop") - sp.total("mc.solve")
                                         - sp.total("mc.tick_block")) / replans
        if self.events is not None:
            B = int(self.inp["goals"].shape[0])
            b1 = sum(roofline.b1_bound(self.ref_cfg, _Shapes(blk))[0] for blk in self.blocks)
            b2 = sum(roofline.b2_bound(B, int(self.loop.substeps_per_plan),
                                       int(self.loop.physics_substeps), blk["S_in"],
                                       blk["spp"], blk["spv"], blk["spa"], blk["gw"],
                                       blk["obs_rows"], blk["S_out"], blk["acc"])[0]
                     for blk in self.blocks)
            for key, bound in (("B1", b1), ("B2", b2)):
                ms = self.events.ms(key, self.marks[key])
                ctx[key.lower()] = {"device_ms": sum(ms), "launches": len(ms),
                                    "bound_ms": bound * self.runs}
        return ctx

    def profiled(self) -> None:
        """One run for the profiler; the window's last run stays the one
        the check reads."""
        kept = self.blocks, self.result
        self.run()
        self.blocks, self.result = kept

    def check(self) -> dict:
        if self.missing:
            raise RuntimeError(f"{', '.join(self.missing)} is gone: the comparison cannot "
                               "follow the program")
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        res = {k: getattr(self.result, k) for k in OUTCOME}
        return checks.closed_loop(self.config["loop"], self.ref_cfg, self.config["controller"],
                                  self.config["plant"], self.inp, self.blocks, res, self.rows)


class _Shapes:
    """The fields of a recorded problem that the bound reads."""

    def __init__(self, blk: dict):
        self.p0, self.obstacles = blk["p0"], blk["obstacles"]
        self.obstacle_mask, self.v_cap = blk["mask"], blk["v_cap"]
