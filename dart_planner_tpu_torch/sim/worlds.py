"""Per-episode randomized obstacle worlds and the mapper perception
pipeline (PyTorch counterpart of :mod:`dart_planner_tpu.sim.worlds`).

Each episode gets a TRUE world (corridor-blocking spheres the plant can
crash into) and a PERCEIVED world (lidar scans rasterized through the
log-odds mapper, then ``extract_obstacles``): what the planner may see.
Perception runs over a batch of episodes at once, in chunks of
``perceive_chunk`` so that only that many dense grids are alive.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dart_planner_tpu_torch.perception import mapper as gm

Tensor = torch.Tensor


class WorldConfig(NamedTuple):
    """Static world-randomization parameters (the JAX package's fields and
    defaults; see its docstring for the measured scan geometry)."""

    num_obstacles: int = 3  # true spheres per episode
    radius_min: float = 0.4  # m
    radius_max: float = 0.8  # m
    lateral_jitter: float = 1.5  # m, perpendicular offset from the corridor
    z_jitter: float = 0.4  # m, vertical offset from the corridor line
    keepout: float = 1.8  # m, min distance from start/goal centers
    mapper: gm.MapperConfig = gm.MapperConfig(
        resolution=0.5, grid_size=(64, 64, 32), origin=(-16.0, -16.0, -4.0)
    )
    scan_points: int = 5  # lidar scans along the corridor
    scan_span: float = 0.9  # fraction of the corridor the scan walk covers
    scan_z_band: float = 1.2  # m, vertical band the scan planes cover
    num_rays: int = 360
    suppression_radius: float = 1.0  # greedy NMS radius (0 = nearest-K)
    perceive_chunk: int = 256  # episodes per perception chunk
    corridor_samples: int = 24  # corridor coverage profile resolution


def worlds_from_draws(config: WorldConfig, starts: Tensor, goals: Tensor, t: Tensor,
                      off: Tensor, dz: Tensor, radii: Tensor, side_draw: Tensor
                      ) -> tuple[Tensor, Tensor]:
    """Place the spheres from their draws, each (n, K, 1): corridor fraction
    t in [0.25, 0.75], lateral and vertical offsets (already scaled by the
    jitters), radii, and a standard normal whose sign picks the keepout
    push direction. Returns (n, K, 4) spheres and an all-true (n, K) mask."""
    n, K = t.shape[0], t.shape[1]
    on_line = starts[:, None, :] + t * (goals - starts)[:, None, :]
    d = goals - starts
    lat = torch.stack([-d[:, 1], d[:, 0], torch.zeros_like(d[:, 0])], dim=-1)
    lat = lat / torch.clamp(torch.linalg.vector_norm(lat, dim=-1, keepdim=True), min=1e-6)
    centers = on_line + off * lat[:, None, :]
    z = torch.clamp(centers[..., 2] + dz[..., 0], min=0.5)
    centers = torch.cat([centers[..., :2], z[..., None]], dim=-1)
    side = torch.sign(side_draw + 1e-3)
    for anchor in (starts, goals):
        gap = torch.linalg.vector_norm(centers - anchor[:, None, :], dim=-1, keepdim=True)
        need = torch.clamp(config.keepout + radii - gap, min=0.0)
        centers = centers + need * side * lat[:, None, :]
    obstacles = torch.cat([centers, radii], dim=-1)
    return obstacles, torch.ones((n, K), dtype=torch.bool, device=obstacles.device)


def sample_worlds(config: WorldConfig, generator: torch.Generator, n: int,
                  starts, goals) -> tuple[Tensor, Tensor]:
    """Sample per-episode true sphere worlds (n, K, 4) + mask (n, K).

    Spheres sit on the start -> goal corridor (fraction t in [0.25, 0.75])
    with lateral and vertical jitter, then are pushed out of the start and
    goal keepout balls along the lateral direction. Drawn on ``generator``
    (a CPU generator), placed on ``starts``' device."""
    device = starts.device if isinstance(starts, Tensor) else "cpu"
    f32 = torch.float32
    K = config.num_obstacles
    shape = (n, K, 1)
    t = 0.25 + 0.5 * torch.rand(shape, generator=generator, dtype=f32)
    off = config.lateral_jitter * torch.randn(shape, generator=generator, dtype=f32)
    dz = config.z_jitter * torch.randn(shape, generator=generator, dtype=f32)
    radii = config.radius_min + (config.radius_max - config.radius_min) * torch.rand(
        shape, generator=generator, dtype=f32
    )
    side = torch.randn(shape, generator=generator, dtype=f32)
    starts = torch.as_tensor(starts, dtype=f32, device=device).expand(n, 3)
    goals = torch.as_tensor(goals, dtype=f32, device=device).expand(n, 3)
    return worlds_from_draws(
        config, starts, goals,
        *(x.to(device) for x in (t, off, dz, radii, side)),
    )


def _perceive_one(config: WorldConfig, true_obs: Tensor, true_mask: Tensor,
                  start: Tensor, goal: Tensor, max_obstacles: int,
                  corridor_samples: int = 0) -> tuple:
    """Perception of a batch of episodes (leading dims of ``true_obs``
    minus (K, 4); none for one episode): the scans in order, each followed
    by its clip, then the top-K obstacles and, with ``corridor_samples`` >
    0, the corridor's observed-fraction profile."""
    mc = config.mapper
    lead = tuple(true_obs.shape[:-2])
    vm = gm.create_map(mc, lead, dtype=true_obs.dtype, device=true_obs.device)
    for i in range(config.scan_points):
        u = i / max(config.scan_points - 1, 1)
        frac = u * config.scan_span  # 0 .. scan_span of the line
        pos = start + frac * (goal - start)
        # a horizontal lidar: stagger the sensor plane across the z band
        pos = torch.cat([pos[..., :2], pos[..., 2:] + (u - 0.5) * config.scan_z_band], -1)
        o, dirs, hd = gm.simulate_lidar_scan(
            mc, pos, true_obs, true_mask, num_rays=config.num_rays
        )
        vm = gm.update_with_scan(mc, vm, o, dirs, hd)
    # window centered on the corridor midpoint, ranked by the whole segment
    obs, mask = gm.extract_obstacles(
        mc, vm, 0.5 * (start + goal), max_obstacles=max_obstacles,
        suppression_radius=config.suppression_radius, toward=goal,
        seg_start=start,
    )
    if corridor_samples:
        cov = gm.corridor_observed_fraction(
            mc, vm, start, goal, num_samples=corridor_samples
        )
        return obs, mask, cov
    return obs, mask


def perceive_worlds(config: WorldConfig, true_obs: Tensor, true_mask: Tensor,
                    starts, goals, max_obstacles: int = 8,
                    corridor_samples: int = 0) -> tuple:
    """Mapper-perceived obstacle sets for every episode: (n, Kp, 4) + mask
    (n, Kp), and with ``corridor_samples`` > 0 a third output (n,
    corridor_samples), the corridor observed-fraction profile. Runs in
    chunks of ``config.perceive_chunk`` episodes (each a batch of dense
    grids, 512 KB each at the default 64 x 64 x 32)."""
    n = true_obs.shape[0]
    kw = dict(dtype=true_obs.dtype, device=true_obs.device)
    starts = torch.as_tensor(starts, **kw).expand(n, 3)
    goals = torch.as_tensor(goals, **kw).expand(n, 3)
    chunk = max(1, min(config.perceive_chunk, n))
    parts = [
        _perceive_one(
            config, true_obs[i:i + chunk], true_mask[i:i + chunk],
            starts[i:i + chunk], goals[i:i + chunk], max_obstacles,
            corridor_samples,
        )
        for i in range(0, n, chunk)
    ]
    return tuple(torch.cat(out, dim=0) for out in zip(*parts))


def monte_carlo_with_worlds(
    loop_config,
    world_config: WorldConfig,
    generator: torch.Generator,
    num_episodes: int,
    start_center,
    goal_center,
    start_spread: float = 2.0,
    goal_spread: float = 2.0,
    method: str = "auto",
):
    """The full Monte-Carlo fleet: randomized starts and goals, wind, sensor
    noise and per-episode TRUE obstacle worlds PERCEIVED through the mapper;
    the planner flies on the perceived set, crashes are judged against the
    truth. Fleet, worlds and episode draw from ``generator`` in that order.
    Returns (EpisodeResult, (true_obstacles, mask), (perceived, mask))."""
    from dart_planner_tpu_torch.sim import closed_loop

    gen, states, goals = closed_loop.sample_fleet(
        generator, num_episodes, start_center, goal_center, start_spread,
        goal_spread,
    )
    tobs, tmask = sample_worlds(world_config, gen, num_episodes, states.position, goals)
    want_corridor = (
        loop_config.unknown_speed_cap > 0.0 and world_config.corridor_samples > 0
    )
    perceived = perceive_worlds(
        world_config, tobs, tmask, states.position, goals,
        max_obstacles=loop_config.mpc.max_obstacles,
        corridor_samples=world_config.corridor_samples if want_corridor else 0,
    )
    pobs, pmask = perceived[0], perceived[1]
    res = closed_loop.simulate_episode(
        loop_config, gen, states, goals, obstacles=pobs, obstacle_mask=pmask,
        method=method, true_obstacles=tobs, true_obstacle_mask=tmask,
        corridor_observed=perceived[2] if want_corridor else None,
    )
    return res, (tobs, tmask), (pobs, pmask)

