"""Scenario-batch parallelism (PyTorch counterpart of
:mod:`dart_planner_tpu.parallel`): contiguous scenario shards over a
("hosts", "devices") grid of torch devices, solved shard by shard with no
communication; only fleet statistics are reduced, across processes with
``torch.distributed``."""

from dart_planner_tpu_torch.parallel.scenario import (
    FleetMesh,
    FleetStats,
    Sharded,
    fleet_statistics,
    make_fleet_mesh,
    shard_scenarios,
    solve_fleet,
)

__all__ = [
    "FleetMesh",
    "FleetStats",
    "Sharded",
    "make_fleet_mesh",
    "shard_scenarios",
    "solve_fleet",
    "fleet_statistics",
]
