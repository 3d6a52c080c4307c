"""Planner interface + registry (PyTorch counterpart of
:mod:`dart_planner_tpu.planning.base`).

A minimal ABC every planner satisfies (plan/obstacles/stats), goal and
state validation, bounded stats tracking, and a name→class registry used
to swap planners.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, List, Optional, Tuple, Type

import numpy as np

from dart_planner_tpu_torch.common.device import to_host
from dart_planner_tpu_torch.common.errors import PlanningError
from dart_planner_tpu_torch.common.types import DroneState, Trajectory

_MAX_STAT_SAMPLES = 100  # reference base_planner.py:103


class BasePlanner(abc.ABC):
    """Abstract trajectory planner (reference base_planner.py:16-110)."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        self.config = dict(config or {})
        self.obstacles: List[Tuple[np.ndarray, float]] = []
        self.planning_stats: Dict[str, Any] = {
            "total_plans": 0,
            "successful_plans": 0,
            "planning_times": [],
            "last_plan_time": 0.0,
        }

    @abc.abstractmethod
    def plan_trajectory(
        self, current_state: DroneState, goal: np.ndarray
    ) -> Optional[Trajectory]:
        """Plan from ``current_state`` to ``goal``; None on failure."""

    @abc.abstractmethod
    def add_obstacle(self, center: np.ndarray, radius: float) -> None:
        """Add a sphere obstacle for avoidance."""

    @abc.abstractmethod
    def clear_obstacles(self) -> None:
        """Remove all obstacles."""

    @abc.abstractmethod
    def get_planning_stats(self) -> Dict[str, Any]:
        """Planner performance statistics."""

    # -- validation (reference base_planner.py:63-88) --
    def validate_goal(self, goal) -> bool:
        goal = np.asarray(goal, np.float64)
        if goal.shape != (3,) or not np.all(np.isfinite(goal)):
            return False
        return bool(goal[2] >= 0.5)  # minimum safe altitude

    def validate_state(self, state: Optional[DroneState]) -> bool:
        if state is None:
            return False
        pos = to_host(state.position)
        vel = to_host(state.velocity)
        if not np.all(np.isfinite(pos)):
            return False
        return bool(np.all(np.abs(vel) <= 20.0))  # 20 m/s envelope

    # -- stats (reference base_planner.py:90-110) --
    def _update_planning_stats(self, planning_time: float, success: bool) -> None:
        st = self.planning_stats
        st["total_plans"] += 1
        st["last_plan_time"] = planning_time
        if success:
            st["successful_plans"] += 1
        st["planning_times"].append(planning_time)
        if len(st["planning_times"]) > _MAX_STAT_SAMPLES:
            st["planning_times"] = st["planning_times"][-_MAX_STAT_SAMPLES:]

    def reset_stats(self) -> None:
        self.planning_stats = {
            "total_plans": 0,
            "successful_plans": 0,
            "planning_times": [],
            "last_plan_time": 0.0,
        }


class PlannerFactory:
    """Name → planner-class registry (reference base_planner.py:114-135)."""

    _planners: Dict[str, Type] = {}

    @classmethod
    def register(cls, name: str, planner_class: Type) -> None:
        cls._planners[name] = planner_class

    @classmethod
    def create(cls, name: str, config: Optional[Dict[str, Any]] = None, **kwargs):
        """An instance of the planner registered as ``name``; ``kwargs``
        (``device`` for example) go to its constructor."""
        if name not in cls._planners:
            raise PlanningError(
                f"Unknown planner: {name}. Available: {cls.list_available()}"
            )
        klass = cls._planners[name]
        return klass(config, **kwargs) if config is not None else klass(**kwargs)

    @classmethod
    def list_available(cls) -> List[str]:
        return sorted(cls._planners)
