"""Planner-to-actuator fast path: one single-scenario solve per replan
feeding the C++ real-time executor (PyTorch counterpart of
:mod:`dart_planner_tpu.runtime.fast_path`).

Per replan: warm-start shift -> solve (the fused CUDA kernel on a GPU) ->
trajectory extraction -> one 13-float setpoint [pos, vel, att(rpy),
body_rates, thrust] fetched to the host and handed to the 400 Hz loop
(``native/rt_executor.cpp``). The warm-start thrust plan stays on the
device between replans.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from dart_planner_tpu_torch.common.device import resolve_device
from dart_planner_tpu_torch.planning import se3_mpc

# Setpoint = horizon step 1 (the first future state; step 0 is now).
_SETPOINT_STEP = 1


class PlannerFastPath:
    """Persistent single-solve dispatch with an on-device warm start."""

    def __init__(
        self,
        config: Optional[se3_mpc.SE3MPCConfig] = None,
        device=None,
        method: str = "auto",
    ):
        self.config = config or se3_mpc.SE3MPCConfig()
        self.device = resolve_device(device)
        self._method = method
        self._u: Optional[torch.Tensor] = None

    def reset(self) -> None:
        self._u = None

    def _step(self, prob, u_prev):
        cfg = self.config
        u0 = se3_mpc.shift_warm_start(cfg, u_prev)
        res = se3_mpc.solve(cfg, prob, u0, method=self._method)
        traj = se3_mpc.extract_trajectory(cfg, res, 0.0)
        i = _SETPOINT_STEP
        sp = torch.cat(
            [
                traj.positions[..., i, :],
                traj.velocities[..., i, :],
                traj.attitudes[..., i, :],
                traj.body_rates[..., i, :],
                traj.thrusts[..., i : i + 1],
            ],
            dim=-1,
        )  # (..., 13)
        return res.thrusts, sp

    def replan(self, position, velocity, goal, obstacles=None) -> np.ndarray:
        """One replan: returns the fetched (13,) setpoint (numpy). Blocking
        by design: the fetch is the dispatch-path latency being measured."""
        prob = se3_mpc.make_problem(
            np.asarray(position, np.float32)[None],
            np.asarray(velocity, np.float32)[None],
            np.asarray(goal, np.float32)[None],
            obstacles=obstacles,
            config=self.config,
            device=self.device,
        )
        if self._u is None:
            self._u = se3_mpc.initialize_thrusts(self.config, prob)
        self._u, sp = self._step(prob, self._u)
        return sp[0].cpu().numpy()

    def push_setpoint(self, loop, setpoint13: np.ndarray) -> None:
        """Hand a replan result to an RT control loop
        (runtime.rt_executor.RealTimeControlLoop or PythonControlLoop)."""
        loop.set_setpoint(
            setpoint13[0:3],
            setpoint13[3:6],
            setpoint13[6:9],
            setpoint13[9:12],
            thrust_ff=float(setpoint13[12]),
        )


def measure_latency(
    fast_path: PlannerFastPath,
    loop,
    n_replans: int = 200,
    goal=(5.0, 3.0, 4.0),
    seed: int = 0,
) -> dict:
    """Measure the planner-to-actuator path: per replan, state -> device ->
    solve -> setpoint fetch -> ``set_setpoint`` on the running RT loop
    (host clock; the fetch synchronizes). The loop's own per-tick times come
    from its circular buffer. Returns p50/p95 of the planning path, the
    control tick, and their sum."""
    rng = np.random.default_rng(seed)
    goal = np.asarray(goal, np.float64)
    positions = rng.normal(0.0, 1.0, (n_replans, 3)) + [0.0, 0.0, 3.0]
    velocities = rng.normal(0.0, 0.5, (n_replans, 3))

    # warm-up: first dispatch (kernel build and constant upload on a GPU)
    sp = fast_path.replan(positions[0], velocities[0], goal)
    fast_path.push_setpoint(loop, sp)

    host = np.empty(n_replans)
    for i in range(n_replans):
        loop.set_state(positions[i], velocities[i], np.zeros(3), np.zeros(3))
        t0 = time.perf_counter()
        sp = fast_path.replan(positions[i], velocities[i], goal)
        fast_path.push_setpoint(loop, sp)
        host[i] = time.perf_counter() - t0

    exec_times = np.asarray(loop.get_execution_times())
    if exec_times.size == 0:
        exec_times = np.zeros(1)
    stats = loop.get_stats()

    def p(v, q):
        return float(np.percentile(v, q) * 1e3)

    return {
        "planning_host_p50_ms": p(host, 50),
        "planning_host_p95_ms": p(host, 95),
        "control_tick_p95_ms": p(exec_times, 95),
        "control_tick_max_ms": float(exec_times.max() * 1e3),
        "planner_to_actuator_p95_ms": p(host, 95) + p(exec_times, 95),
        "rt_loop_missed_deadlines": stats["missed_deadlines"],
        "rt_loop_iterations": stats["iteration_count"],
        "n_replans": n_replans,
    }
