"""The Monte-Carlo fleet's worlds and what the mapper perceives of them: a
frozen copy of the port's ``sim/worlds.py`` (``sample_worlds``,
``perceive_worlds``) and the parts of ``perception/mapper.py`` they call,
so that the benchmark makes the closed loop's inputs itself and hands the
port only the results. Plain PyTorch; imports nothing of the program.

Each episode's TRUE world is a few corridor-blocking spheres; the
PERCEIVED world is lidar scans along the corridor rasterized into a dense
log-odds grid, then the occupied voxels ranked by distance to the corridor
with greedy suppression, and the corridor's observed fraction.
"""

from __future__ import annotations

import math

import numpy as np
import torch

Tensor = torch.Tensor

_LOGODDS_HIT = float(np.log(0.7 / 0.3))  # p_hit = 0.7
_LOGODDS_MISS = float(np.log(0.4 / 0.6))  # p_miss = 0.4
_LOGODDS_CLAMP = float(np.log(0.99 / 0.01))  # prob clamp [0.01, 0.99]


def unit_linspace(num: int, dtype=torch.float32, device="cpu") -> Tensor:
    """``i * (1 / (num - 1))`` in the working precision, the end point
    exactly 1."""
    if num == 1:
        return torch.zeros(1, dtype=dtype, device=device)
    t = torch.arange(num - 1, dtype=dtype, device=device) * (1.0 / (num - 1))
    return torch.cat([t, torch.ones(1, dtype=dtype, device=device)])


def _sq3(d: Tensor) -> Tensor:
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


class Grid:
    """The mapper's geometry: voxel size, voxels per axis, origin, range."""

    def __init__(self, resolution: float, grid_size, origin, max_range: float = 50.0):
        self.resolution = float(resolution)
        self.grid_size = tuple(int(n) for n in grid_size)
        self.origin = tuple(float(o) for o in origin)
        self.max_range = float(max_range)
        self.ray_samples = int(np.ceil(self.max_range / (0.9 * self.resolution))) + 1

    def to_voxel(self, p: Tensor) -> Tensor:
        o = torch.tensor(self.origin, dtype=p.dtype, device=p.device)
        return torch.floor((p - o) / self.resolution).to(torch.int64)

    def to_world(self, idx: Tensor) -> Tensor:
        o = torch.tensor(self.origin, dtype=torch.float32, device=idx.device)
        return idx.to(torch.float32) * self.resolution + (o + 0.5 * self.resolution)

    def flat(self, idx: Tensor) -> tuple[Tensor, Tensor]:
        gs = self.grid_size
        inb = ((idx >= 0) & (idx < torch.tensor(gs, device=idx.device))).all(-1)
        f = (idx[..., 0] * gs[1] + idx[..., 1]) * gs[2] + idx[..., 2]
        return torch.where(inb, f, -1), inb

    @property
    def voxels(self) -> int:
        return math.prod(self.grid_size)


def _offsets(C: int, extra: int, V: int, device) -> Tensor:
    off = torch.arange(C, dtype=torch.int64, device=device) * V
    return off.reshape((C,) + (1,) * extra)


def lidar(grid: Grid, pos: Tensor, obs: Tensor, mask: Tensor, rays: int):
    """Horizontal scan by exact ray-sphere casting from ``pos`` (C, 3):
    (origins, directions, hit distances, inf for a miss)."""
    dtype, device = pos.dtype, pos.device
    C = pos.shape[0]
    ang = 2 * math.pi * torch.arange(rays, dtype=dtype, device=device) / rays
    dirs = torch.stack([torch.cos(ang), torch.sin(ang), torch.zeros_like(ang)], dim=-1)
    oc = pos[:, None, :] - obs[..., :3]
    r2 = obs[..., 3] ** 2
    b = (dirs[:, None, 0] * oc[:, None, :, 0] + dirs[:, None, 1] * oc[:, None, :, 1]
         + dirs[:, None, 2] * oc[:, None, :, 2])
    c = (_sq3(oc) - r2)[:, None, :]
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0, t1 = -b - sq, -b + sq
    t = torch.where(t0 > 1e-6, t0, t1)
    hit = (disc >= 0) & (t > 1e-6) & mask[:, None, :]
    hd = torch.where(hit, t, math.inf).amin(-1)
    return pos[:, None, :].expand(C, rays, 3), dirs.expand(C, rays, 3), hd


def scan_update(grid: Grid, lo: Tensor, origins: Tensor, dirs: Tensor, hit: Tensor) -> Tensor:
    """The Bayesian update of grids ``lo`` (C, X, Y, Z) along the rays:
    free-space samples before the hit cell get the miss update, the hit
    cell the hit update (two scatter-adds), then the clip."""
    S, res = grid.ray_samples, grid.resolution
    C = lo.shape[0]
    dtype, device = lo.dtype, lo.device
    V = grid.voxels
    hd = torch.clamp(hit, max=grid.max_range)
    is_hit = hit <= grid.max_range
    t = (torch.arange(S, dtype=dtype, device=device) + 0.5) * (0.9 * res)
    pts = origins[..., :, None, :] + t[:, None] * dirs[..., :, None, :]
    flat, inb = grid.flat(grid.to_voxel(pts))
    valid = inb & (t < hd[..., None] - 0.5 * res)
    dup = torch.cat([torch.zeros_like(valid[..., :1]), flat[..., 1:] == flat[..., :-1]],
                    dim=-1)
    valid = valid & ~dup
    off = _offsets(C, 2, V, device)
    g = lo.reshape(-1).clone()
    upd = torch.where(valid, _LOGODDS_MISS, 0.0).to(dtype)
    g.index_add_(0, (torch.where(valid, flat, 0) + off).reshape(-1), upd.reshape(-1))
    hit_flat, hit_inb = grid.flat(grid.to_voxel(origins + hd[..., None] * dirs))
    hv = hit_inb & is_hit
    g.index_add_(0, (torch.where(hv, hit_flat, 0) + off[..., 0]).reshape(-1),
                 torch.where(hv, _LOGODDS_HIT, 0.0).to(dtype).reshape(-1))
    return torch.clamp(g, -_LOGODDS_CLAMP, _LOGODDS_CLAMP).reshape(lo.shape)


def extract(grid: Grid, lo: Tensor, center: Tensor, K: int, suppression: float,
            toward: Tensor, seg_start: Tensor, size: int = 32, threshold: float = 0.6):
    """The occupied voxels of the (size)^3 window around ``center`` as K
    padded spheres of radius one voxel, ranked by distance to the segment
    seg_start -> toward, with greedy suppression within ``suppression``."""
    C = lo.shape[0]
    s = size
    dtype, device = lo.dtype, lo.device
    start = grid.to_voxel(center) - s // 2
    gs = torch.tensor(grid.grid_size, device=device)
    start = torch.minimum(torch.clamp(start, min=0), gs - s)
    idx = (start[..., None] + torch.arange(s, device=device)).reshape(-1, 3, s)
    c = torch.arange(C, device=device)
    window = lo[c[:, None, None, None], idx[:, 0, :, None, None], idx[:, 1, None, :, None],
                idx[:, 2, None, None, :]]
    occ = torch.sigmoid(window)
    corner = grid.to_world(start) - 0.5 * grid.resolution
    ar = torch.arange(s, device=device)
    gidx = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), dim=-1)
    centers = ((gidx.to(dtype) + 0.5) * grid.resolution).reshape(-1, 3) + corner[:, None, :]
    occupied = (occ > threshold).reshape(C, -1)
    seg = toward - seg_start
    rel = centers - seg_start[:, None, :]
    tt = torch.clamp(
        (rel[..., 0] * seg[:, None, 0] + rel[..., 1] * seg[:, None, 1]
         + rel[..., 2] * seg[:, None, 2]) / torch.clamp(_sq3(seg), min=1e-9)[:, None],
        0.0, 1.0)
    nearest = seg_start[:, None, :] + tt[..., None] * seg[:, None, :]
    score = torch.where(occupied, -_sq3(centers - nearest), -math.inf)
    r2 = suppression * suppression
    picks, tops = [], []
    for _ in range(K):
        i = torch.argmax(score, dim=-1)
        tops.append(torch.gather(score, -1, i[:, None])[:, 0])
        picks.append(i)
        ci = torch.gather(centers, -2, i[:, None, None].expand(C, 1, 3))
        score = torch.where(_sq3(centers - ci) <= r2, -math.inf, score)
    top, fidx = torch.stack(tops, -1), torch.stack(picks, -1)
    mask = torch.isfinite(top)
    oc = torch.gather(centers, -2, fidx[..., None].expand(C, K, 3))
    radii = torch.full((C, K, 1), grid.resolution, dtype=dtype, device=device)
    return torch.where(mask[..., None], torch.cat([oc, radii], -1), 0.0), mask


def corridor_observed(grid: Grid, lo: Tensor, start: Tensor, goal: Tensor, samples: int,
                      probe: float = 0.75) -> Tensor:
    """Observed fraction along start -> goal, (C, samples): each sample
    probes its voxel and 6 neighbours at ``probe``."""
    dtype, device = start.dtype, start.device
    C = lo.shape[0]
    t = unit_linspace(samples, dtype, device)
    pts = start[:, None, :] + t[:, None] * (goal - start)[:, None, :]
    eye = torch.eye(3, dtype=dtype, device=device) * probe
    offs = torch.cat([torch.zeros((1, 3), dtype=dtype, device=device), eye, -eye], dim=0)
    probes = pts[..., :, None, :] + offs
    flat, inb = grid.flat(grid.to_voxel(probes))
    flat = torch.where(inb, flat, 0) + _offsets(C, flat.ndim - 1, grid.voxels, device)
    seen = inb & (lo.reshape(-1)[flat].abs() > 1e-6)
    return seen.to(dtype).mean(-1)


def place_spheres(w: dict, starts: Tensor, goals: Tensor, t, off, dz, radii, side):
    """Spheres on the start -> goal corridor from their draws, pushed out of
    the start and goal keepout balls along the lateral direction."""
    n, K = t.shape[0], t.shape[1]
    on_line = starts[:, None, :] + t * (goals - starts)[:, None, :]
    d = goals - starts
    lat = torch.stack([-d[:, 1], d[:, 0], torch.zeros_like(d[:, 0])], dim=-1)
    lat = lat / torch.clamp(torch.linalg.vector_norm(lat, dim=-1, keepdim=True), min=1e-6)
    centers = on_line + off * lat[:, None, :]
    z = torch.clamp(centers[..., 2] + dz[..., 0], min=0.5)
    centers = torch.cat([centers[..., :2], z[..., None]], dim=-1)
    sgn = torch.sign(side + 1e-3)
    for anchor in (starts, goals):
        gap = torch.linalg.vector_norm(centers - anchor[:, None, :], dim=-1, keepdim=True)
        need = torch.clamp(w["keepout"] + radii - gap, min=0.0)
        centers = centers + need * sgn * lat[:, None, :]
    return torch.cat([centers, radii], dim=-1), torch.ones((n, K), dtype=torch.bool,
                                                           device=centers.device)


def sample_worlds(w: dict, gen: torch.Generator, n: int, starts: Tensor, goals: Tensor):
    """True worlds (n, K, 4) and mask, drawn on the CPU generator ``gen``
    in the port's order (fraction, lateral, vertical, radius, side)."""
    f32 = torch.float32
    shape = (n, int(w["num_obstacles"]), 1)
    t = 0.25 + 0.5 * torch.rand(shape, generator=gen, dtype=f32)
    off = w["lateral_jitter"] * torch.randn(shape, generator=gen, dtype=f32)
    dz = w["z_jitter"] * torch.randn(shape, generator=gen, dtype=f32)
    radii = w["radius_min"] + (w["radius_max"] - w["radius_min"]) * torch.rand(
        shape, generator=gen, dtype=f32)
    side = torch.randn(shape, generator=gen, dtype=f32)
    dev = starts.device
    return place_spheres(w, starts, goals, *(x.to(dev) for x in (t, off, dz, radii, side)))


def perceive(w: dict, tobs: Tensor, tmask: Tensor, starts: Tensor, goals: Tensor,
             K: int) -> tuple[Tensor, Tensor, Tensor]:
    """What the mapper perceives of each world, in chunks of
    ``perceive_chunk`` episodes: (n, K, 4) spheres, (n, K) mask and the
    corridor's observed fraction (n, corridor_samples)."""
    grid = Grid(w["resolution"], w["grid_size"], w["origin"])
    n = tobs.shape[0]
    chunk = max(1, min(int(w["perceive_chunk"]), n))
    parts = []
    for i in range(0, n, chunk):
        o, m = tobs[i:i + chunk], tmask[i:i + chunk]
        s, g = starts[i:i + chunk], goals[i:i + chunk]
        lo = torch.zeros((o.shape[0],) + grid.grid_size, dtype=o.dtype, device=o.device)
        P = int(w["scan_points"])
        for j in range(P):
            u = j / max(P - 1, 1)
            pos = s + (u * w["scan_span"]) * (g - s)
            pos = torch.cat([pos[..., :2], pos[..., 2:] + (u - 0.5) * w["scan_z_band"]], -1)
            lo = scan_update(grid, lo, *lidar(grid, pos, o, m, int(w["num_rays"])))
        obs, mask = extract(grid, lo, 0.5 * (s + g), K, w["suppression_radius"], g, s)
        parts.append((obs, mask, corridor_observed(grid, lo, s, g, int(w["corridor_samples"]))))
    return tuple(torch.cat(x, dim=0) for x in zip(*parts))
