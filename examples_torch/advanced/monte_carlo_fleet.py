"""Advanced: a Monte-Carlo fleet with mapper-perceived worlds and in-flight
sensing.

PyTorch counterpart of examples/advanced/monte_carlo_fleet.py, the full
Monte-Carlo pipeline at example scale. Draw randomized start/goal pairs and
per-episode TRUE sphere worlds; perceive them through the voxel mapper
(scans -> log-odds -> blob-suppressed extraction); then fly every episode
closed-loop in one batched call: 10 Hz SE(3) MPC replans, 400 Hz geometric
control, wind, sensor noise, and 3 m proximity sensing that reveals
blind-spot spheres mid-flight. On the card (the default) each replan is
one launch of kernel B1 and its 40 control ticks one launch of kernel B2;
with ``--device cpu`` both are the plain PyTorch loops.

Drawing and flying are apart: :func:`fly` takes the draws (and optionally
the wind and the sensor noise), so the same fleet can be flown from draws
made elsewhere. The draws come from a CPU ``torch.Generator`` seeded with
``--seed``; ``jax.random``'s draws cannot be reproduced in torch.

    PYTHONPATH=. python examples_torch/advanced/monte_carlo_fleet.py [--device cpu]
"""

import argparse

import torch

from dart_planner_tpu_torch.common.device import resolve_device
from dart_planner_tpu_torch.planning import se3_mpc
from dart_planner_tpu_torch.sim import ClosedLoopConfig, WorldConfig, closed_loop
from dart_planner_tpu_torch.sim.worlds import perceive_worlds, sample_worlds

START = (0.0, 0.0, 3.0)
GOAL = (6.0, 3.0, 4.0)


def loop_config() -> ClosedLoopConfig:
    return ClosedLoopConfig(
        # a small horizon keeps the example quick on the CPU; the bench
        # fleet (chip_smoke.py phase 9) flies N=20
        mpc=se3_mpc.SE3MPCConfig(prediction_horizon=8, max_iterations=6, tail_iterations=0),
        wind_mean=1.0,
        wind_std=0.5,
        sensor_noise_std=0.02,
        sense_radius=3.0,
        # unknown-space conservatism: cap the planned speed at 2 m/s near
        # corridor regions the pre-flight scans never observed
        unknown_speed_cap=2.0,
    )


def draw(generator: torch.Generator, episodes: int, device, world_config=WorldConfig()):
    """Starts, goals and TRUE worlds on ``device``, drawn on ``generator``
    in that order: (states, goals, true spheres, their mask)."""
    _, states, goals = closed_loop.sample_fleet(
        generator, episodes, torch.tensor(START, device=device),
        torch.tensor(GOAL, device=device),
    )
    tobs, tmask = sample_worlds(world_config, generator, episodes, states.position, goals)
    return states, goals, tobs, tmask


def fly(config: ClosedLoopConfig, states, goals, tobs, tmask, generator=None,
        method: str = "auto", world_config=WorldConfig(), wind=None, noise=None):
    """Perceive the true worlds through the mapper, then fly every episode
    on what was perceived, its crashes judged against the truth. What is
    random in flight and not given (``wind``, ``noise``) is drawn from
    ``generator``. Returns the EpisodeResult."""
    pobs, pmask, corridor = perceive_worlds(
        world_config, tobs, tmask, states.position, goals,
        max_obstacles=config.mpc.max_obstacles,
        corridor_samples=world_config.corridor_samples,
    )
    return closed_loop.simulate_episode(
        config, generator, states, goals, obstacles=pobs, obstacle_mask=pmask,
        method=method, true_obstacles=tobs, true_obstacle_mask=tmask,
        corridor_observed=corridor, wind=wind, noise=noise,
    )


def summary(res) -> dict:
    return {
        "episodes": int(res.success.shape[0]),
        "success_rate": float(res.success.float().mean()),
        "crash_rate": float(res.crashed.float().mean()),
        "tracking_rmse_m": float(res.tracking_rmse.mean()),
        "mean_min_clearance_m": float(res.min_obstacle_clearance.mean()),
        "final_distance_p50_m": float(res.final_distance.quantile(0.5)),
    }


def report(out: dict) -> None:
    """Print :func:`summary`'s numbers as the JAX example prints its own."""
    print(f"episodes:        {out['episodes']}")
    print(f"success rate:    {out['success_rate']:.3f}")
    print(f"crash rate:      {out['crash_rate']:.3f}")
    print(f"tracking RMSE:   {out['tracking_rmse_m']:.3f} m")
    print(f"min true-sphere clearance (fleet mean): {out['mean_min_clearance_m']:.2f} m")
    print(f"final distance p50: {out['final_distance_p50_m']:.2f} m")


def main(episodes: int = 32, seed: int = 0, device=None, method: str = "auto") -> dict:
    """Draw and fly ``episodes`` episodes. Returns the printed numbers and
    the EpisodeResult under ``"result"``."""
    dev = resolve_device(device)
    config = loop_config()
    generator = torch.Generator().manual_seed(seed)
    states, goals, tobs, tmask = draw(generator, episodes, dev)
    res = fly(config, states, goals, tobs, tmask, generator, method=method)
    out = summary(res)
    report(out)
    return {**out, "result": res}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; cpu runs the plain loops)")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    main(seed=args.seed, device=args.device)
