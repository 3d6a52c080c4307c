"""Advanced: shard a scenario fleet over a ("hosts", "devices") mesh.

PyTorch counterpart of examples/advanced/fleet_sharding.py. A Monte-Carlo
fleet of 64 scenarios a device is split over every visible card; each
shard is solved on its own card (kernel B1, two launches a shard: the
shard and its tail) with no communication between shards, and the fleet
statistics are reduced over the shards. ``--device cpu`` runs the plain
loop on a mesh of eight CPU devices, as the JAX example's virtual CPU mesh:

    PYTHONPATH=. python examples_torch/advanced/fleet_sharding.py --device cpu
"""

import argparse

import numpy as np
import torch

from dart_planner_tpu_torch.parallel import scenario
from dart_planner_tpu_torch.planning import se3_mpc

CPU_MESH_DEVICES = 8


def fleet_mesh(device=None) -> scenario.FleetMesh:
    """Every visible card (``device`` None; raises without one), eight CPU
    devices for a CPU ``device``, or the one card named."""
    if device is None:
        return scenario.make_fleet_mesh()
    dev = torch.device(device)
    return scenario.make_fleet_mesh([dev] * (CPU_MESH_DEVICES if dev.type == "cpu" else 1))


def main(per_device: int = 64, config=None, device=None, method: str = "auto") -> dict:
    """Solve ``per_device`` scenarios a mesh device at ``config`` (default
    N=12, 8 Newton rounds, the tail on). Returns the printed numbers and
    the Sharded result under ``"result"``."""
    mesh = fleet_mesh(device)
    n_dev = mesh.size
    print(f"mesh: {mesh.shape} ({n_dev} devices)")

    config = config or se3_mpc.SE3MPCConfig(prediction_horizon=12, max_iterations=8)
    B = per_device * n_dev
    rng = np.random.default_rng(0)
    lift = np.float32([0, 0, 5])
    prob = se3_mpc.make_problem(
        rng.normal(0, 2, (B, 3)).astype(np.float32) + lift,
        rng.normal(0, 1, (B, 3)).astype(np.float32),
        rng.normal(0, 5, (B, 3)).astype(np.float32) + lift,
        config=config,
        device=mesh.local_devices[0],
    )
    prob = scenario.shard_scenarios(prob, mesh)

    result, stats = scenario.solve_fleet(config, mesh, prob, use_obstacles=False,
                                         method=method)
    out = {name: float(getattr(stats, name)) for name in stats._fields}
    print(f"fleet of {int(out['total'])}: {int(out['converged'])} converged, "
          f"mean cost {out['mean_cost']:,.0f}, max grad norm {out['max_grad_norm']:.3f}")
    out["shard_shapes"] = sorted({tuple(s.thrusts.shape) for s in result.shards})
    print(f"per-device shard shapes: {out['shard_shapes']}")
    return {**out, "mesh": mesh.shape, "result": result}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: every visible card; cpu: eight CPU "
                             "devices)")
    main(device=parser.parse_args().device)
