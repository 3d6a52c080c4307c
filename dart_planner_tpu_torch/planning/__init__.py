"""Trajectory planning: the SE(3) MPC solve and planner facade (L2), and
global mission planning (L1, ``planning.global_mission``)."""

from dart_planner_tpu_torch.planning.base import BasePlanner, PlannerFactory
from dart_planner_tpu_torch.planning.se3_mpc import (
    SE3MPCConfig,
    SE3MPCPlanner,
    SolveResult,
    make_problem,
    solve,
    solve_se3_mpc,
)
from dart_planner_tpu_torch.planning.reference_mode import solve_reference_mode

PlannerFactory.register("se3_mpc", SE3MPCPlanner)

__all__ = [
    "BasePlanner",
    "PlannerFactory",
    "SE3MPCConfig",
    "SE3MPCPlanner",
    "SolveResult",
    "make_problem",
    "solve",
    "solve_se3_mpc",
    "solve_reference_mode",
]
