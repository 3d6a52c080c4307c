"""The quiet-failure (timeout) cohort of the PyTorch port's Monte-Carlo
fleet (the port's counterpart of scripts/diag_timeouts.py, which imports JAX
and stays).

The bench config-4 fleet (randomized starts and goals, wind, sensor noise,
mapper-perceived sphere worlds, 3 m in-flight sensing, the 2 m/s
unknown-space cap) at the shipping config: of the episodes that neither
crash nor reach the goal in 6 s, this census asks

  1. who they are (initial distance, closest approach, final distance,
     unknown-corridor exposure, obstacle clearance);
  2. whether they succeed with more time (8 s and 10 s: 80 and 100
     replans);
  3. whether the unknown-space cap causes them (the same fleet, cap off).

Every row flies the same draws: :func:`build_fleet` draws the fleet, its
true worlds, the wind and the sensor noise once, for the largest replan
count, and each row takes the wind and its first ``num_replans`` noise
blocks, so the 8 s row shares the 6 s row's wind and first 60 noise blocks
(as the JAX script's rows share one episode key). The draws come from a CPU
``torch.Generator`` seeded with ``--seed``; ``jax.random``'s cannot be
reproduced in torch, so the fleet is a fresh sample of the JAX script's.
On a card ``--method auto`` flies each replan through kernel B1 and its
ticks through kernel B2; ``torch`` is the plain path. Each row carries its
time: CUDA events on a card beside the card's name and power limit as
nvidia-smi gives them, the host clock on the CPU.

    python scripts/diag_timeouts_torch.py                  # the card, 2048 episodes
    python scripts/diag_timeouts_torch.py --device cpu --episodes 16

Without a card it exits non-zero unless ``--device cpu`` is given. Imports
the port only. :func:`build_fleet`, :func:`fly` and :func:`base_config`
serve scripts/diag_goalclamp_torch.py and scripts/diag_unknown_torch.py.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import NamedTuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dart_planner_tpu_torch.common.device import card_label, to_host  # noqa: E402
from dart_planner_tpu_torch.sim import ClosedLoopConfig, WorldConfig, closed_loop  # noqa: E402
from dart_planner_tpu_torch.sim import physics  # noqa: E402
from dart_planner_tpu_torch.sim.worlds import perceive_worlds, sample_worlds  # noqa: E402

from diag_convergence_torch import script_device, timed  # noqa: E402

START = (0.0, 0.0, 3.0)
GOAL = (6.0, 3.0, 4.0)
MAX_OBSTACLES = 8
# the rows of the census: (label, replans, unknown-space cap)
TIMEOUT_ROWS = (("6s shipping (cap 2.0)", 60, 2.0), ("8s shipping (cap 2.0)", 80, 2.0),
                ("10s shipping (cap 2.0)", 100, 2.0), ("6s cap OFF", 60, 0.0))


class Fleet(NamedTuple):
    """One Monte-Carlo fleet and its draws, on one device."""

    states: object  # DroneState (n,)
    goals: torch.Tensor  # (n, 3)
    true_obstacles: torch.Tensor  # (n, K, 4)
    true_mask: torch.Tensor  # (n, K)
    obstacles: torch.Tensor  # (n, 8, 4) perceived
    mask: torch.Tensor  # (n, 8)
    corridor: torch.Tensor  # (n, M) observed fraction along the corridor
    wind: torch.Tensor  # (n, 3)
    noise: torch.Tensor  # (max replans, n, 6) additive position/velocity noise


def base_config() -> ClosedLoopConfig:
    """The JAX script's shipping row."""
    return ClosedLoopConfig(wind_mean=1.0, wind_std=0.5, sensor_noise_std=0.02,
                            sense_radius=3.0, unknown_speed_cap=2.0)


def build_fleet(episodes: int, seed: int, device, config: ClosedLoopConfig = None,
                max_replans: int = 100, world_config: WorldConfig = WorldConfig()) -> Fleet:
    """The fleet (``sample_fleet``), its true worlds (``sample_worlds``), what
    the mapper perceives of them with the corridor's coverage
    (``perceive_worlds``), then the wind and ``max_replans`` blocks of
    sensor noise, drawn once as ``simulate_episode`` draws them, all on one
    CPU generator seeded ``seed``, in that order."""
    config = config or base_config()
    gen = torch.Generator().manual_seed(seed)
    _, states, goals = closed_loop.sample_fleet(
        gen, episodes, torch.tensor(START, device=device), torch.tensor(GOAL, device=device))
    tobs, tmask = sample_worlds(world_config, gen, episodes, states.position, goals)
    pobs, pmask, cov = perceive_worlds(world_config, tobs, tmask, states.position, goals,
                                       max_obstacles=MAX_OBSTACLES,
                                       corridor_samples=world_config.corridor_samples)
    dtype = states.position.dtype
    wind = physics.sample_wind(gen, (episodes,), config.wind_mean, config.wind_std, dtype,
                               device)
    noise = config.sensor_noise_std * torch.randn(
        (max_replans, episodes, 6), generator=gen, dtype=dtype).to(device)
    return Fleet(states, goals, tobs, tmask, pobs, pmask, cov, wind, noise)


def fly(config: ClosedLoopConfig, fleet: Fleet, method: str = "auto", use_cov: bool = True):
    """One row: every episode of ``fleet`` at ``config``, on its wind and its
    first ``config.num_replans`` noise blocks. Returns (EpisodeResult, ms)."""
    if config.num_replans > fleet.noise.shape[0]:
        raise ValueError(f"{config.num_replans} replans, {fleet.noise.shape[0]} noise blocks")
    return timed(lambda: closed_loop.simulate_episode(
        config, None, fleet.states, fleet.goals, obstacles=fleet.obstacles,
        obstacle_mask=fleet.mask, method=method, true_obstacles=fleet.true_obstacles,
        true_obstacle_mask=fleet.true_mask,
        corridor_observed=fleet.corridor if use_cov else None,
        wind=fleet.wind, noise=fleet.noise[:config.num_replans]), fleet.goals.device)


def initial_distance(fleet: Fleet) -> np.ndarray:
    return np.linalg.norm(to_host(fleet.states.position) - to_host(fleet.goals), axis=-1)


def unknown_any(fleet: Fleet, coverage: float) -> np.ndarray:
    """Per episode, whether a corridor sample's coverage is below
    ``coverage``."""
    return (to_host(fleet.corridor) < coverage).any(axis=1)


def census(tag, res, d0, unk_any):
    """The JAX script's census of one row (numpy on the result's arrays,
    which may be tensors on any device or arrays); returns the timeout
    mask."""
    succ, crash = to_host(res.success, bool), to_host(res.crashed, bool)
    tout = ~succ & ~crash
    print(
        f"{tag}: success={succ.mean():.4f} crash={crash.mean():.4f} "
        f"timeout={tout.mean():.4f}"
    )
    if tout.any():
        fd = to_host(res.final_distance)[tout]
        md = to_host(res.min_distance)[tout]
        cl = to_host(res.min_obstacle_clearance)[tout]
        print(
            f"  timeouts: n={tout.sum()}  initial dist "
            f"p50={np.percentile(d0[tout], 50):.2f} "
            f"p90={np.percentile(d0[tout], 90):.2f} "
            f"(fleet p50={np.percentile(d0, 50):.2f})"
        )
        print(
            f"  final dist p50={np.percentile(fd, 50):.2f} "
            f"p90={np.percentile(fd, 90):.2f}  "
            f"closest approach p50={np.percentile(md, 50):.2f}  "
            f"near-goal (min_d<2m)={np.mean(md < 2.0):.3f}  "
            f"goal-touch (min_d<1m)={np.mean(md < 1.0):.3f}"
        )
        print(
            f"  unknown-corridor episodes={unk_any[tout].mean():.3f} "
            f"(fleet base rate {unk_any.mean():.3f})  "
            f"min clearance p10={np.percentile(cl, 10):.2f}"
        )
    return tout


def row_configs(base: ClosedLoopConfig) -> list:
    """(label, config, whether the row keys the cap on the corridor) of each
    census row."""
    return [(label, base._replace(num_replans=n, unknown_speed_cap=cap), cap > 0.0)
            for label, n, cap in TIMEOUT_ROWS]


def rows(fleet: Fleet, method: str = "auto", base: ClosedLoopConfig = None,
         label: str = "") -> dict:
    """The census rows on ``fleet``, printed; the 6 s timeouts that succeed at
    8 s and 10 s, and the timeout overlap with the cap on and off. Returns
    each row's rates, time and result, and the counts."""
    base = base or base_config()
    d0, unk = initial_distance(fleet), unknown_any(fleet, base.unknown_coverage)
    out, touts = {}, {}
    for tag, cfg, use_cov in row_configs(base):
        res, ms = fly(cfg, fleet, method, use_cov)
        print(f"  ({ms:.3f} ms, {label})")
        touts[tag] = census(tag, res, d0, unk)
        out[tag] = {"success": float(res.success.float().mean()),
                    "crash": float(res.crashed.float().mean()),
                    "timeout": float(touts[tag].mean()), "ms": ms,
                    "replans": cfg.num_replans, "result": res}
        if cfg.num_replans > 60:
            later = touts["6s shipping (cap 2.0)"] & to_host(res.success, bool)
            t6 = int(touts["6s shipping (cap 2.0)"].sum())
            print(f"  6s-timeouts that SUCCEED at {cfg.num_replans // 10}s: "
                  f"{int(later.sum())}/{t6}")
            out[tag]["six_s_timeouts_that_succeed"] = int(later.sum())
    t6, t0 = touts["6s shipping (cap 2.0)"], touts["6s cap OFF"]
    overlap = {"both": int((t6 & t0).sum()), "cap_on_only": int((t6 & ~t0).sum()),
               "cap_off_only": int((~t6 & t0).sum())}
    print(f"  timeout overlap cap-on/cap-off: {overlap['both']} "
          f"(cap-on-only {overlap['cap_on_only']}, cap-off-only {overlap['cap_off_only']})",
          flush=True)
    return {"rows": out, "overlap": overlap}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="the device to fly on (default cuda; cpu runs the plain path)")
    ap.add_argument("--episodes", type=int, default=2048)
    ap.add_argument("--method", default="auto", choices=closed_loop.METHODS,
                    help="auto: kernels B1 and B2 on a card, the plain path on the CPU")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = script_device(ap, args.device)
    label = card_label(device)
    print(f"platform={device.type} ({label}) episodes={args.episodes}", flush=True)
    fleet = build_fleet(args.episodes, args.seed, device)
    return rows(fleet, args.method, label=label)


if __name__ == "__main__":
    main()
