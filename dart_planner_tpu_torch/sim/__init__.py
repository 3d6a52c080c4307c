"""Simulation: batched drone physics and closed-loop Monte-Carlo fleets
(PyTorch counterpart of :mod:`dart_planner_tpu.sim`)."""

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
]
