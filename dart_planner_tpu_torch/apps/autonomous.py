"""Edge-first onboard autonomous controller with tiered failsafe
(PyTorch counterpart of :mod:`dart_planner_tpu.apps.autonomous`).

Parity port of the reference ``OnboardAutonomousController``
(the reference's edge/onboard_autonomous_controller.py, "OAC"):
operational modes NOMINAL/DEGRADED/AUTONOMOUS/EMERGENCY keyed on
connection quality (OAC:19-64), local obstacle store, and performance/
status reporting (OAC:93-115). The reference's AUTONOMOUS branch computes
a guidance velocity and then discards it, always emitting hover thrust;
here AUTONOMOUS mode actually replans locally with the onboard SE(3) MPC
against the local obstacle set — a strict functional superset on the same
API.

Mode policy:

- NOMINAL   (quality > 0.8, fresh cloud trajectory): track it.
- DEGRADED  (quality > 0.3): track the last *cached* cloud trajectory
  (the controller caches every trajectory it is handed, so a stalled
  link degrades gracefully without caller-side caching).
- AUTONOMOUS (else): replan onboard toward the stored goal.
- EMERGENCY: latched by :meth:`trigger_emergency` or automatically after
  ``max_plan_failures`` consecutive onboard replan failures; descends at
  reduced thrust.

The onboard planner, its warm start and the commands live on one device
(``device``, default: the card); an AUTONOMOUS replan is one solve
there (kernel B1 on the card). Host reads are explicit.
"""

from __future__ import annotations

import enum
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dart_planner_tpu_torch.common.device import to_host
from dart_planner_tpu_torch.common.types import ControlCommand, DroneState, Trajectory
from dart_planner_tpu_torch.control.onboard import OnboardController
from dart_planner_tpu_torch.planning.se3_mpc import SE3MPCConfig, SE3MPCPlanner


class OperationalMode(enum.Enum):
    """(OAC:19-25)"""

    NOMINAL = "nominal"
    DEGRADED = "degraded"
    AUTONOMOUS = "autonomous"
    EMERGENCY = "emergency"


class OnboardAutonomousController:
    """Edge-first flight controller with local-MPC fallback (OAC:28-115)."""

    def __init__(
        self,
        control_frequency: float = 10.0,
        planner_config: Optional[SE3MPCConfig] = None,
        replan_interval_s: float = 0.5,
        max_plan_failures: int = 5,
        device=None,
    ):
        self.control_frequency = control_frequency
        self.current_mode = OperationalMode.AUTONOMOUS
        self.goal_position: Optional[np.ndarray] = None
        self.local_obstacles: List[Tuple[np.ndarray, float]] = []
        self.control_loop_times: List[float] = []
        self.failsafe_activations = 0
        self.replan_interval_s = replan_interval_s
        self.max_plan_failures = max_plan_failures
        self._consecutive_plan_failures = 0
        self._cached_cloud_trajectory: Optional[Trajectory] = None

        self._planner = SE3MPCPlanner(
            planner_config
            or SE3MPCConfig(prediction_horizon=10, max_iterations=6),
            device=device,
        )
        self.device = self._planner.device
        self._tracker = OnboardController()
        self._local_trajectory: Optional[Trajectory] = None
        self._last_replan_t = -np.inf
        self._emergency_latched = False

    # -- goal / obstacles (OAC:40-47) ----------------------------------
    def set_goal(self, goal_position) -> None:
        self.goal_position = np.asarray(goal_position, np.float64).copy()

    def add_local_obstacle(self, center, radius: float) -> None:
        center = np.asarray(center, np.float64).copy()
        self.local_obstacles.append((center, float(radius)))
        self._planner.add_obstacle(center, float(radius))

    def clear_local_obstacles(self) -> None:
        self.local_obstacles.clear()
        self._planner.clear_obstacles()

    def trigger_emergency(self) -> None:
        self._emergency_latched = True
        self.failsafe_activations += 1

    # -- mode selection (OAC:58-64) ------------------------------------
    def _select_mode(
        self, connection_quality: float, cloud_trajectory: Optional[Trajectory]
    ) -> OperationalMode:
        if self._emergency_latched:
            return OperationalMode.EMERGENCY
        if connection_quality > 0.8 and cloud_trajectory is not None:
            return OperationalMode.NOMINAL
        if connection_quality > 0.3 and (
            cloud_trajectory is not None
            or self._cached_cloud_trajectory is not None
        ):
            return OperationalMode.DEGRADED
        return OperationalMode.AUTONOMOUS

    # -- control loop (OAC:49-91) --------------------------------------
    def compute_control_command(
        self,
        current_state: DroneState,
        cloud_trajectory: Optional[Trajectory] = None,
        connection_quality: float = 0.0,
    ) -> ControlCommand:
        start = time.perf_counter()
        if cloud_trajectory is not None:
            self._cached_cloud_trajectory = cloud_trajectory
        self.current_mode = self._select_mode(connection_quality, cloud_trajectory)

        if self.current_mode is OperationalMode.EMERGENCY:
            cmd = self._emergency_descent(current_state)
        elif self.current_mode in (
            OperationalMode.NOMINAL,
            OperationalMode.DEGRADED,
        ):
            cmd, _ = self._tracker.compute_control_command(
                current_state, cloud_trajectory or self._cached_cloud_trajectory
            )
        else:  # AUTONOMOUS: local replanning
            traj = self._local_plan(current_state)
            if traj is None:
                cmd = self._tracker.get_fallback_command(current_state)
            else:
                cmd, _ = self._tracker.compute_control_command(
                    current_state, traj
                )

        self.control_loop_times.append(
            (time.perf_counter() - start) * 1000.0
        )
        if len(self.control_loop_times) > 5000:
            self.control_loop_times = self.control_loop_times[-5000:]
        return cmd

    def _local_plan(self, state: DroneState) -> Optional[Trajectory]:
        """Onboard SE(3) MPC replan, throttled to replan_interval_s."""
        if self.goal_position is None:
            return None
        now = float(to_host(state.timestamp))
        if (
            self._local_trajectory is None
            or now - self._last_replan_t >= self.replan_interval_s
        ):
            try:
                self._local_trajectory = self._planner.plan_trajectory(
                    state, self.goal_position
                )
                self._last_replan_t = now
                self._consecutive_plan_failures = 0
            except Exception:
                self.failsafe_activations += 1
                self._consecutive_plan_failures += 1
                if self._consecutive_plan_failures >= self.max_plan_failures:
                    # onboard planning is persistently failing: latch the
                    # emergency descent rather than hovering blind forever
                    self._emergency_latched = True
                return None
        return self._local_trajectory

    def _emergency_descent(self, state: DroneState) -> ControlCommand:
        """Constant-rate descent at reduced thrust (controlled let-down)."""
        mass = self._tracker.mass
        return ControlCommand(
            thrust=torch.tensor(0.8 * mass * 9.81, dtype=torch.float32, device=self.device),
            torque=torch.zeros(3, dtype=torch.float32, device=self.device),
        )

    # -- reporting (OAC:93-115) ----------------------------------------
    def get_performance_stats(self) -> Dict[str, Any]:
        if not self.control_loop_times:
            return {"status": "no_data"}
        return {
            "mean_loop_time_ms": float(np.mean(self.control_loop_times)),
            "current_mode": self.current_mode.value,
            "total_loops": len(self.control_loop_times),
        }

    def get_system_status(self) -> Dict[str, Any]:
        return {
            "current_mode": self.current_mode.value,
            "has_goal": self.goal_position is not None,
            "control_loops_executed": len(self.control_loop_times),
            "avg_loop_time_ms": (
                float(np.mean(self.control_loop_times))
                if self.control_loop_times
                else 0.0
            ),
            "failsafe_activations": self.failsafe_activations,
            "local_obstacles": len(self.local_obstacles),
            "planner_stats": self._planner.get_planning_stats(),
        }
