"""Intermediate: one batched call solves thousands of MPC problems on the card.

PyTorch counterpart of examples/intermediate/batched_solves.py: 2048
randomized scenarios (starts, goals, four obstacle spheres each) are one
batched call into the same solver the single-vehicle path uses. On the card
(the default) the two-phase solve launches kernel B1 twice, once for the
batch and once for its unconverged tail; with ``--device cpu`` it runs the
plain PyTorch loop.

    PYTHONPATH=. python examples_torch/intermediate/batched_solves.py [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from dart_planner_tpu_torch.common.device import card_label, resolve_device
from dart_planner_tpu_torch.planning import se3_mpc


def scenario_arrays(batch: int, seed: int = 0) -> tuple:
    """The JAX example's draws in its order, as float32 numpy: start
    positions, velocities, goals and (batch, 4, 4) obstacle spheres."""
    rng = np.random.default_rng(seed)
    obstacles = np.concatenate(
        [rng.normal(0, 4, (batch, 4, 3)), rng.uniform(0.3, 1.2, (batch, 4, 1))],
        axis=-1,
    ).astype(np.float32)
    lift = np.float32([0, 0, 5])
    position = rng.normal(0, 2, (batch, 3)).astype(np.float32) + lift
    velocity = rng.normal(0, 1, (batch, 3)).astype(np.float32)
    goal = rng.normal(0, 5, (batch, 3)).astype(np.float32) + lift
    return position, velocity, goal, obstacles


def main(batch: int = 2048, config=None, device=None, method: str = "auto") -> dict:
    """Solve ``batch`` scenarios at ``config`` (default ``SE3MPCConfig()``,
    N=20) twice and time the second solve: CUDA events on the card, the
    host clock on the CPU. Returns the printed numbers and the
    SolveResult under ``"result"``."""
    dev = resolve_device(device)
    config = config or se3_mpc.SE3MPCConfig()
    position, velocity, goal, obstacles = scenario_arrays(batch)
    prob = se3_mpc.make_problem(position, velocity, goal, obstacles=obstacles,
                                config=config, device=dev)

    se3_mpc.solve(config, prob, method=method)  # the first call builds the kernel
    if dev.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        result = se3_mpc.solve(config, prob, method=method)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
    else:
        t0 = time.perf_counter()
        result = se3_mpc.solve(config, prob, method=method)
        ms = 1e3 * (time.perf_counter() - t0)

    out = {
        "batch": batch,
        "ms": ms,
        "solves_per_s": batch / (ms / 1e3),
        "converged": float(result.converged.float().mean()),
        "mean_cost": float(result.cost.double().mean()),
        "worst_miss_m": float(torch.linalg.vector_norm(
            result.positions[:, -1] - prob.goal, dim=-1).max()),
        "card": card_label(dev),
    }
    print(f"{batch} scenarios in {ms:.1f} ms -> {out['solves_per_s']:,.0f} solves/s "
          f"({out['card']})")
    print(f"converged: {out['converged']:.1%}   mean cost: {out['mean_cost']:,.0f}")
    print(f"worst terminal miss: {out['worst_miss_m']:.2f} m")
    return {**out, "result": result}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; cpu runs the plain loop)")
    main(device=parser.parse_args().device)
