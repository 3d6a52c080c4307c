"""The benchmark's one traffic generator. A traffic mix is a data file under
``benchmark/traffic/``; its ``generator`` key names one of the functions in
:data:`GENERATORS`, which reads the rest of the file's parameters and the
configuration's scale and draws every input from ``--seed``. The program
receives only what comes out.

- ``sphere_fleet``: the repository bench's solve problems (``bench.py``
  and ``bench_torch.py``'s ``bench_problem``): live spheres of N(0, s)
  centres and uniform radii a scenario, start, velocity and goal, drawn by
  numpy in that order; then a pool of further start/velocity sets, one for
  each replan in turn, as a vehicle's state is fresh at every replan.
- ``perceived_fleet``: the closed loop's Monte-Carlo fleet
  (``scripts/diag_timeouts_torch.py``'s ``build_fleet``): starts and goals
  around two centres, each episode's true sphere world and what the mapper
  perceives of it, the wind, and the sensor noise of every replan, all from
  one CPU ``torch.Generator`` in that order.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.lib import perception


def seed_value(seed: int) -> int:
    """Any whole number as a generator seed (numpy and torch take
    non-negative seeds below 2**64)."""
    return int(seed) % (2 ** 63)


def sphere_fleet(traffic: dict, config: dict, seed: int, device) -> dict:
    """Problems of ``config["scenarios"]`` scenarios and a pool of
    ``traffic["state_pool"]`` start/velocity/timestamp sets on ``device``.
    The first set is the bench's own draw, so the pool's first problem is
    the bench problem of this seed."""
    rng = np.random.default_rng(seed_value(seed))
    B = int(config["scenarios"])
    L = int(traffic["live_spheres"])
    f32 = np.float32
    obs = np.concatenate([
        rng.normal(0, traffic["centre_std"], (B, L, 3)),
        rng.uniform(traffic["radius_low"], traffic["radius_high"], (B, L, 1)),
    ], axis=-1).astype(f32)
    start_off = np.asarray(traffic["start_offset"], f32)
    goal_off = np.asarray(traffic["goal_offset"], f32)
    p = [rng.normal(0, traffic["start_std"], (B, 3)).astype(f32) + start_off]
    v = [rng.normal(0, traffic["velocity_std"], (B, 3)).astype(f32)]
    goal = rng.normal(0, traffic["goal_std"], (B, 3)).astype(f32) + goal_off
    for _ in range(int(traffic["state_pool"]) - 1):
        p.append(rng.normal(0, traffic["start_std"], (B, 3)).astype(f32) + start_off)
        v.append(rng.normal(0, traffic["velocity_std"], (B, 3)).astype(f32))
    dt = float(traffic["replan_period_s"])
    stamps = (dt * np.arange(len(p), dtype=f32))[:, None].repeat(B, 1)

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    return {"obstacles": dev(obs), "goal": dev(goal), "positions": dev(np.stack(p)),
            "velocities": dev(np.stack(v)), "timestamps": dev(stamps)}


def sample_wind(gen: torch.Generator, n: int, mean: float, std: float) -> torch.Tensor:
    """Constant wind an episode: a uniform direction times N(mean, std)."""
    d = torch.randn((n, 3), generator=gen, dtype=torch.float32)
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-9)
    return d * (mean + std * torch.randn((n, 1), generator=gen, dtype=torch.float32))


def perceived_fleet(traffic: dict, config: dict, seed: int, device) -> dict:
    """The Monte-Carlo fleet of ``config["episodes"]`` episodes on
    ``device``: starts and goals, true and perceived worlds, the corridor's
    coverage, the wind and the sensor noise of ``loop.num_replans`` replans,
    drawn from one CPU generator in the port's order."""
    n = int(config["episodes"])
    loop = config["loop"]
    gen = torch.Generator().manual_seed(seed_value(seed))
    f32 = torch.float32
    sc = torch.tensor(traffic["start_center"], dtype=f32)
    gc = torch.tensor(traffic["goal_center"], dtype=f32)
    starts = sc + traffic["start_spread"] * torch.randn((n, 3), generator=gen, dtype=f32)
    starts[:, 2] = torch.clamp(starts[:, 2], min=1.0)
    goals = gc + traffic["goal_spread"] * torch.randn((n, 3), generator=gen, dtype=f32)
    goals[:, 2] = torch.clamp(goals[:, 2], min=1.0)
    starts, goals = starts.to(device), goals.to(device)
    world = traffic["world"]
    tobs, tmask = perception.sample_worlds(world, gen, n, starts, goals)
    pobs, pmask, cov = perception.perceive(world, tobs, tmask, starts, goals,
                                           int(traffic["max_perceived"]))
    wind = sample_wind(gen, n, loop["wind_mean"], loop["wind_std"]).to(device)
    noise = loop["sensor_noise_std"] * torch.randn(
        (int(loop["num_replans"]), n, 6), generator=gen, dtype=f32)
    return {"starts": starts, "goals": goals, "true_obstacles": tobs, "true_mask": tmask,
            "obstacles": pobs, "mask": pmask, "corridor": cov, "wind": wind,
            "noise": noise.to(device)}


GENERATORS = {"sphere_fleet": sphere_fleet, "perceived_fleet": perceived_fleet}


def generate(traffic: dict, config: dict, seed: int, device) -> dict:
    """The inputs that ``traffic``'s generator draws for ``config``."""
    return GENERATORS[traffic["generator"]](traffic, config, seed, device)
