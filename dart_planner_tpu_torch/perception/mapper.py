"""Dense log-odds voxel mapper (PyTorch counterpart of
:mod:`dart_planner_tpu.perception.mapper`).

A fixed-extent dense log-odds grid:

- the Bayesian scan update (p_hit = 0.7, p_miss = 0.4, probabilities
  clamped to [0.01, 0.99]) is two scatter-adds (``index_add_``) along
  fixed-count ray samples with consecutive-duplicate suppression, then a
  clip;
- occupancy queries (prior 0.5 for unknown or out-of-grid cells), the
  observed test, corridor coverage, trajectory safety with 6-neighbour
  probes, local occupancy grids, sphere injection and exact ray-sphere
  lidar casting are fixed-shape tensor ops;
- ``extract_obstacles`` turns occupied voxels into padded sphere obstacles
  (nearest-K, or greedy suppression ranked by distance to a segment).

Where the JAX package vmaps over episodes, every function here also takes
a leading batch of maps: a ``VoxelMap`` whose ``log_odds`` is
``(C, X, Y, Z)`` goes with positions, rays and centers that carry the same
leading ``(C,)``; scatter indices are offset per episode into one flat
buffer. Rays update the grid in place of a copy: ``update_with_scan``
returns a new map and leaves its input alone.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from dart_planner_tpu_torch.common.device import resolve_device

Tensor = torch.Tensor

_LOGODDS_HIT = float(np.log(0.7 / 0.3))  # p_hit = 0.7
_LOGODDS_MISS = float(np.log(0.4 / 0.6))  # p_miss = 0.4
_LOGODDS_CLAMP = float(np.log(0.99 / 0.01))  # prob clamp [0.01, 0.99]
_LOGODDS_OBSTACLE = float(np.log(0.9 / 0.1))  # injected spheres


class MapperConfig(NamedTuple):
    """Static mapper geometry (the JAX package's fields and defaults)."""

    resolution: float = 0.5  # m per voxel
    grid_size: tuple = (128, 128, 64)  # voxels per axis
    origin: tuple = (-32.0, -32.0, -8.0)  # world position of voxel (0,0,0)
    max_range: float = 50.0  # sensor range

    @property
    def ray_samples(self) -> int:
        """Fixed sample count so ray updates have a static shape."""
        return int(np.ceil(self.max_range / (0.9 * self.resolution))) + 1


class VoxelMap(NamedTuple):
    """The map state: dense log-odds grid(s) (prior 0 == probability 0.5)."""

    log_odds: Tensor  # (..., X, Y, Z) float32
    total_observations: Tensor  # (...,) int32


def unit_linspace(num: int, dtype=torch.float32, device="cpu") -> Tensor:
    """``jnp.linspace(0, 1, num)`` bit for bit: ``i * (1 / (num - 1))`` in
    the working precision, as XLA evaluates JAX's ``i / (num - 1)``, with
    the end point exactly 1 (``torch.linspace`` rounds some interior points
    differently)."""
    if num == 1:
        return torch.zeros(1, dtype=dtype, device=device)
    t = torch.arange(num - 1, dtype=dtype, device=device) * (1.0 / (num - 1))
    return torch.cat([t, torch.ones(1, dtype=dtype, device=device)])


def create_map(config: MapperConfig, batch_shape: tuple = (), dtype=torch.float32,
               device=None) -> VoxelMap:
    batch_shape = tuple(batch_shape)
    device = resolve_device(device)
    return VoxelMap(
        log_odds=torch.zeros(batch_shape + tuple(config.grid_size), dtype=dtype,
                             device=device),
        total_observations=torch.zeros(batch_shape, dtype=torch.int32, device=device),
    )


def world_to_voxel(config: MapperConfig, position: Tensor) -> Tensor:
    """floor((p - origin) / res) as int64 voxel indices."""
    origin = torch.tensor(config.origin, dtype=position.dtype, device=position.device)
    return torch.floor((position - origin) / config.resolution).to(torch.int64)


def voxel_to_world(config: MapperConfig, idx: Tensor) -> Tensor:
    """Voxel center."""
    origin = torch.tensor(config.origin, dtype=torch.float32, device=idx.device)
    return idx.to(torch.float32) * config.resolution + (origin + 0.5 * config.resolution)


def _flat_index(config: MapperConfig, idx: Tensor) -> tuple[Tensor, Tensor]:
    """Flatten (..., 3) voxel indices; returns (flat_idx, in_bounds)."""
    gs = config.grid_size
    in_bounds = (
        (idx >= 0) & (idx < torch.tensor(gs, device=idx.device))
    ).all(-1)
    flat = (idx[..., 0] * gs[1] + idx[..., 1]) * gs[2] + idx[..., 2]
    return torch.where(in_bounds, flat, -1), in_bounds


def _lead(vm: VoxelMap) -> tuple:
    return tuple(vm.log_odds.shape[:-3])


def _episode_offsets(lead: tuple, ndim_extra: int, V: int, device) -> Tensor:
    """Flat-buffer offset of each map, shaped to broadcast against indices
    with ``ndim_extra`` trailing dims after the leading batch."""
    C = math.prod(lead)
    off = torch.arange(C, dtype=torch.int64, device=device).reshape(lead) * V
    return off.reshape(lead + (1,) * ndim_extra)


def _gather(vm: VoxelMap, config: MapperConfig, positions: Tensor):
    """Log-odds at world positions (lead + (..., 3)) and the in-bounds
    mask; out-of-grid positions read 0."""
    lead = _lead(vm)
    V = math.prod(config.grid_size)
    flat, inb = _flat_index(config, world_to_voxel(config, positions))
    flat = torch.where(inb, flat, 0)
    flat = flat + _episode_offsets(lead, flat.ndim - len(lead), V, flat.device)
    lo = vm.log_odds.reshape(-1)[flat]
    return lo, inb


def update_with_scan(
    config: MapperConfig,
    vmap_state: VoxelMap,
    origins: Tensor,  # lead + (R, 3) ray origins
    directions: Tensor,  # lead + (R, 3) unit directions
    hit_distances: Tensor,  # lead + (R,): inf (or > max_range) = miss
) -> VoxelMap:
    """Bayesian update along R rays per map: free-space samples before the
    hit cell get the miss update, the hit cell the hit update, then the
    clip. Two scatter-adds whatever the rays hold."""
    S = config.ray_samples
    res = config.resolution
    lead = _lead(vmap_state)
    dtype, device = vmap_state.log_odds.dtype, vmap_state.log_odds.device
    V = math.prod(config.grid_size)

    hd = torch.clamp(hit_distances, max=config.max_range)
    is_hit = hit_distances <= config.max_range

    # free-space samples strictly before the hit cell
    t = (torch.arange(S, dtype=dtype, device=device) + 0.5) * (0.9 * res)
    pts = origins[..., :, None, :] + t[:, None] * directions[..., :, None, :]
    flat, inb = _flat_index(config, world_to_voxel(config, pts))  # lead+(R,S)
    valid = inb & (t < hd[..., None] - 0.5 * res)
    dup = torch.cat(
        [torch.zeros_like(valid[..., :1]), flat[..., 1:] == flat[..., :-1]], dim=-1
    )
    valid = valid & ~dup
    off = _episode_offsets(lead, 2, V, device)

    grid = vmap_state.log_odds.reshape(-1).clone()
    upd = torch.where(valid, _LOGODDS_MISS, 0.0).to(dtype)
    grid.index_add_(0, (torch.where(valid, flat, 0) + off).reshape(-1), upd.reshape(-1))

    # hit cells
    hit_pts = origins + hd[..., None] * directions
    hit_flat, hit_inb = _flat_index(config, world_to_voxel(config, hit_pts))
    hit_valid = hit_inb & is_hit
    hit_upd = torch.where(hit_valid, _LOGODDS_HIT, 0.0).to(dtype)
    grid.index_add_(
        0, (torch.where(hit_valid, hit_flat, 0) + off[..., 0]).reshape(-1),
        hit_upd.reshape(-1),
    )

    grid = torch.clamp(grid, -_LOGODDS_CLAMP, _LOGODDS_CLAMP)
    return VoxelMap(
        log_odds=grid.reshape(vmap_state.log_odds.shape),
        total_observations=vmap_state.total_observations + origins.shape[-2],
    )


def query_occupancy(config: MapperConfig, vmap_state: VoxelMap, positions: Tensor) -> Tensor:
    """Occupancy probability at world positions; prior 0.5 outside the grid
    or for never-observed cells."""
    lo, inb = _gather(vmap_state, config, positions)
    return torch.sigmoid(torch.where(inb, lo, 0.0))


def query_observed(config: MapperConfig, vmap_state: VoxelMap, positions: Tensor,
                   eps: float = 1e-6) -> Tensor:
    """True where the voxel holding ``positions`` has ever been observed:
    in-bounds and |log-odds| > eps. Out-of-grid counts as unobserved."""
    lo, inb = _gather(vmap_state, config, positions)
    return inb & (lo.abs() > eps)


def _probe_offsets(radius: float, dtype, device) -> Tensor:
    eye = torch.eye(3, dtype=dtype, device=device) * radius
    return torch.cat([torch.zeros((1, 3), dtype=dtype, device=device), eye, -eye], dim=0)


def corridor_observed_fraction(
    config: MapperConfig,
    vmap_state: VoxelMap,
    start: Tensor,  # lead + (3,)
    goal: Tensor,  # lead + (3,)
    num_samples: int = 24,
    probe_radius: float = 0.75,
) -> Tensor:
    """Observed fraction along the start -> goal corridor, lead +
    (num_samples,): each sample probes its voxel and 6 cardinal neighbours
    at ``probe_radius``."""
    dtype, device = start.dtype, start.device
    t = unit_linspace(num_samples, dtype, device)
    pts = start[..., None, :] + t[:, None] * (goal - start)[..., None, :]
    probes = pts[..., :, None, :] + _probe_offsets(probe_radius, dtype, device)
    seen = query_observed(config, vmap_state, probes)
    return seen.to(dtype).mean(-1)


def is_trajectory_safe(
    config: MapperConfig,
    vmap_state: VoxelMap,
    positions: Tensor,  # lead + (..., N, 3)
    safety_margin: float = 1.0,
    threshold: float = 0.6,
) -> Tensor:
    """All waypoints and their 6 cardinal margin probes at occupancy <=
    threshold. Returns positions' batch shape, bool."""
    probes = positions[..., None, :] + _probe_offsets(
        safety_margin, positions.dtype, positions.device
    )
    occ = query_occupancy(config, vmap_state, probes)
    return (occ <= threshold).all(-1).all(-1)


def local_occupancy_grid(
    config: MapperConfig,
    vmap_state: VoxelMap,
    center: Tensor,  # lead + (3,)
    size_cells: int = 32,
) -> tuple[Tensor, Tensor]:
    """(occupancy lead + (s, s, s), world position of its corner lead + (3,))
    around ``center``; the window clamps at the grid's borders."""
    lead = _lead(vmap_state)
    s = size_cells
    start = world_to_voxel(config, center) - s // 2
    gs = torch.tensor(config.grid_size, device=start.device)
    start = torch.minimum(torch.clamp(start, min=0), gs - s)
    # one (s, s, s) gather per map, the maps flattened to a leading C
    idx = (start[..., None] + torch.arange(s, device=start.device)).reshape(-1, 3, s)
    lo = vmap_state.log_odds.reshape((-1,) + tuple(config.grid_size))
    c = torch.arange(lo.shape[0], device=lo.device)
    window = lo[
        c[:, None, None, None], idx[:, 0, :, None, None], idx[:, 1, None, :, None],
        idx[:, 2, None, None, :],
    ].reshape(lead + (s, s, s))
    corner = voxel_to_world(config, start) - 0.5 * config.resolution
    return torch.sigmoid(window), corner


def _sq3(d: Tensor) -> Tensor:
    """Sum of squares over a trailing axis of 3, in the order x, y, z."""
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def extract_obstacles(
    config: MapperConfig,
    vmap_state: VoxelMap,
    center: Tensor,
    max_obstacles: int = 8,
    threshold: float = 0.6,
    size_cells: int = 32,
    suppression_radius: float = 0.0,
    toward: Optional[Tensor] = None,
    seg_start: Optional[Tensor] = None,
) -> tuple[Tensor, Tensor]:
    """Occupied voxels of the local window as padded sphere obstacles,
    lead + (K, 4) with mask lead + (K,); each sphere has radius
    ``resolution``.

    Ranking: nearest to ``center``, or with ``toward`` set, nearest to the
    segment seg_start -> toward (seg_start defaults to ``center``). With
    ``suppression_radius`` > 0, greedy non-maximum suppression: after each
    pick, voxels within that radius are excluded."""
    occ, corner = local_occupancy_grid(config, vmap_state, center, size_cells)
    lead = tuple(occ.shape[:-3])
    s = size_cells
    dtype, device = occ.dtype, occ.device
    ar = torch.arange(s, device=device)
    grid_idx = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), dim=-1)
    flat_centers = (
        (grid_idx.to(dtype) + 0.5) * config.resolution
    ).reshape(-1, 3) + corner[..., None, :]  # lead + (s^3, 3)
    occupied = (occ > threshold).reshape(lead + (-1,))
    if toward is None:
        d2 = _sq3(flat_centers - center[..., None, :])
    else:
        a = center if seg_start is None else torch.as_tensor(seg_start, dtype=dtype,
                                                             device=device)
        seg = torch.as_tensor(toward, dtype=dtype, device=device) - a
        rel = flat_centers - a[..., None, :]
        t = torch.clamp(
            (rel[..., 0] * seg[..., None, 0] + rel[..., 1] * seg[..., None, 1]
             + rel[..., 2] * seg[..., None, 2])
            / torch.clamp(_sq3(seg), min=1e-9)[..., None],
            0.0, 1.0,
        )
        nearest = a[..., None, :] + t[..., None] * seg[..., None, :]
        d2 = _sq3(flat_centers - nearest)
    score = torch.where(occupied, -d2, -math.inf)
    if suppression_radius > 0.0:
        r2 = suppression_radius * suppression_radius
        picks, tops = [], []
        for _ in range(max_obstacles):
            idx = torch.argmax(score, dim=-1)
            tops.append(torch.gather(score, -1, idx[..., None])[..., 0])
            picks.append(idx)
            c = torch.gather(
                flat_centers, -2, idx[..., None, None].expand(lead + (1, 3))
            )
            score = torch.where(_sq3(flat_centers - c) <= r2, -math.inf, score)
        top, flat_idx = torch.stack(tops, -1), torch.stack(picks, -1)
    else:
        # a stable descending sort: ties keep index order, as lax.top_k does
        top, flat_idx = torch.sort(score, dim=-1, descending=True, stable=True)
        top, flat_idx = top[..., :max_obstacles], flat_idx[..., :max_obstacles]
    mask = torch.isfinite(top)
    obs_centers = torch.gather(
        flat_centers, -2, flat_idx[..., None].expand(lead + (max_obstacles, 3))
    )
    radii = torch.full(lead + (max_obstacles, 1), config.resolution, dtype=dtype,
                       device=device)
    obstacles = torch.cat([obs_centers, radii], dim=-1)
    return torch.where(mask[..., None], obstacles, 0.0), mask


def add_obstacle(config: MapperConfig, vmap_state: VoxelMap, center: Tensor,
                 radius) -> VoxelMap:
    """Inject a sphere at occupancy 0.9 as a dense mask."""
    lo = vmap_state.log_odds
    axes = [torch.arange(n, device=lo.device) for n in config.grid_size]
    idx = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    centers = voxel_to_world(config, idx)
    center = torch.as_tensor(center, dtype=centers.dtype, device=lo.device)
    radius = torch.as_tensor(radius, dtype=centers.dtype, device=lo.device)
    inside = _sq3(centers - center[..., None, None, None, :]) <= radius[..., None, None, None] ** 2
    return vmap_state._replace(
        log_odds=torch.where(inside, torch.tensor(_LOGODDS_OBSTACLE, dtype=lo.dtype,
                                                  device=lo.device), lo)
    )


def simulate_lidar_scan(
    config: MapperConfig,
    position: Tensor,  # lead + (3,) sensor position
    obstacles: Tensor,  # lead + (K, 4) analytic spheres
    obstacle_mask: Tensor,  # lead + (K,)
    num_rays: int = 360,
) -> tuple[Tensor, Tensor, Tensor]:
    """Horizontal lidar scan by exact ray-sphere casting. Returns (origins
    lead + (R, 3), directions (R, 3) broadcast to lead, hit distances lead +
    (R,), inf for a miss): the input of :func:`update_with_scan`."""
    dtype, device = position.dtype, position.device
    lead = tuple(position.shape[:-1])
    ang = 2 * math.pi * torch.arange(num_rays, dtype=dtype, device=device) / num_rays
    dirs = torch.stack([torch.cos(ang), torch.sin(ang), torch.zeros_like(ang)], dim=-1)
    oc = position[..., None, :] - obstacles[..., :3]  # lead + (K, 3)
    r2 = obstacles[..., 3] ** 2
    b = (
        dirs[:, None, 0] * oc[..., None, :, 0]
        + dirs[:, None, 1] * oc[..., None, :, 1]
        + dirs[:, None, 2] * oc[..., None, :, 2]
    )  # lead + (R, K)
    c = (_sq3(oc) - r2)[..., None, :]
    disc = b * b - c
    sqrt_disc = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = -b - sqrt_disc
    t1 = -b + sqrt_disc
    t = torch.where(t0 > 1e-6, t0, t1)
    hit = (disc >= 0) & (t > 1e-6) & obstacle_mask[..., None, :]
    t_min = torch.where(hit, t, math.inf).amin(-1)
    origins = position[..., None, :].expand(lead + (num_rays, 3))
    return origins, dirs.expand(lead + (num_rays, 3)), t_min


class GeometricMapper:
    """Stateful facade over one map on one device."""

    def __init__(
        self,
        resolution: float = 0.5,
        max_range: float = 50.0,
        config: Optional[MapperConfig] = None,
        device=None,
    ):
        self.config = config or MapperConfig(resolution=resolution, max_range=max_range)
        self.device = resolve_device(device)
        self.map = create_map(self.config, device=self.device)
        self.total_queries = 0

    def _t(self, x, dtype=torch.float32) -> Tensor:
        return torch.as_tensor(np.asarray(x), device=self.device).to(dtype)

    def update_map(self, origins, directions, hit_distances) -> None:
        self.map = update_with_scan(
            self.config, self.map, self._t(origins), self._t(directions),
            self._t(hit_distances),
        )

    def query_occupancy(self, position) -> np.ndarray:
        self.total_queries += 1
        return query_occupancy(self.config, self.map, self._t(position)).cpu().numpy()

    def is_collision(self, position, threshold: float = 0.6) -> bool:
        return bool(self.query_occupancy(position) > threshold)

    def is_trajectory_safe(self, positions, safety_margin: float = 1.0,
                           threshold: float = 0.6) -> bool:
        return bool(
            is_trajectory_safe(self.config, self.map, self._t(positions),
                               safety_margin, threshold)
        )

    def get_local_occupancy_grid(self, center, size_cells: int = 32):
        occ, corner = local_occupancy_grid(self.config, self.map, self._t(center),
                                           size_cells)
        return occ.cpu().numpy(), corner.cpu().numpy()

    def extract_obstacles(self, center, max_obstacles: int = 8, **kw):
        obs, mask = extract_obstacles(self.config, self.map, self._t(center),
                                      max_obstacles, **kw)
        return obs.cpu().numpy(), mask.cpu().numpy()

    def add_obstacle(self, center, radius: float) -> None:
        self.map = add_obstacle(self.config, self.map, self._t(center), float(radius))

    def simulate_lidar_scan(self, position, obstacles, obstacle_mask=None,
                            num_rays: int = 360):
        obstacles = self._t(obstacles)
        if obstacle_mask is None:
            obstacle_mask = torch.ones(obstacles.shape[0], dtype=torch.bool,
                                       device=self.device)
        return simulate_lidar_scan(self.config, self._t(position), obstacles,
                                   self._t(obstacle_mask, torch.bool), num_rays)

    def get_mapping_stats(self) -> dict:
        lo = self.map.log_odds
        return {
            "total_voxels": int((lo.abs() > 1e-6).sum()),
            "occupied_voxels": int((torch.sigmoid(lo) > 0.6).sum()),
            "total_observations": int(self.map.total_observations),
            "total_queries": self.total_queries,
            "resolution": self.config.resolution,
            "max_range": self.config.max_range,
        }
