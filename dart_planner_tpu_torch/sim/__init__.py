"""Simulation: batched drone physics, closed-loop Monte-Carlo fleets, the
BASELINE scenario library and the resumable sweep (PyTorch counterpart of
:mod:`dart_planner_tpu.sim`)."""

from dart_planner_tpu_torch.sim.physics import (
    PhysicsConfig,
    RigidBodyState,
    point_mass_step,
    rigid_body_step,
    sample_wind,
)
from dart_planner_tpu_torch.sim.closed_loop import (
    ClosedLoopConfig,
    EpisodeResult,
    simulate_episode,
    monte_carlo,
)
from dart_planner_tpu_torch.sim.worlds import (
    WorldConfig,
    sample_worlds,
    perceive_worlds,
)
from dart_planner_tpu_torch.sim.scenarios import (
    Figure8Result,
    figure8_tracking,
    hover_to_waypoint,
    mapper_navigation,
)
from dart_planner_tpu_torch.sim.checkpoint import (
    FleetCheckpoint,
    load_checkpoint,
    run_sweep,
    save_checkpoint,
)

__all__ = [
    "PhysicsConfig",
    "RigidBodyState",
    "point_mass_step",
    "rigid_body_step",
    "sample_wind",
    "ClosedLoopConfig",
    "EpisodeResult",
    "simulate_episode",
    "monte_carlo",
    "WorldConfig",
    "sample_worlds",
    "perceive_worlds",
    "Figure8Result",
    "figure8_tracking",
    "hover_to_waypoint",
    "mapper_navigation",
    "FleetCheckpoint",
    "load_checkpoint",
    "run_sweep",
    "save_checkpoint",
]
