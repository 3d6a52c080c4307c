"""Perception: the dense log-odds voxel mapper (PyTorch counterpart of
:mod:`dart_planner_tpu.perception`)."""

from dart_planner_tpu_torch.perception.mapper import (
    MapperConfig,
    VoxelMap,
    create_map,
    update_with_scan,
    query_occupancy,
    query_observed,
    corridor_observed_fraction,
    is_trajectory_safe,
    local_occupancy_grid,
    extract_obstacles,
    simulate_lidar_scan,
    GeometricMapper,
)

__all__ = [
    "MapperConfig",
    "VoxelMap",
    "create_map",
    "update_with_scan",
    "query_occupancy",
    "query_observed",
    "corridor_observed_fraction",
    "is_trajectory_safe",
    "local_occupancy_grid",
    "extract_obstacles",
    "simulate_lidar_scan",
    "GeometricMapper",
]
