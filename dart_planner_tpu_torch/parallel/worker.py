"""Per-process entry of the multi-process fleet harness (PyTorch counterpart
of the JAX package's ``scripts/distributed_worker.py``).

    python -m dart_planner_tpu_torch.parallel.worker --coordinator localhost:PORT \\
        --num-processes 2 --process-id 0 --backend gloo

Launched once per process (``tests/test_torch_distributed.py`` starts two on
gloo). Every process:

1. joins the process group (gloo with ``--local-devices`` CPU devices, or
   NCCL with that many cards);
2. builds the global ("hosts", "devices") mesh;
3. builds ONLY ITS OWN slice of a seeded global scenario fleet;
4. runs ``parallel.scenario.solve_fleet`` (stats by ``all_reduce``);
5. process 0 prints one ``RESULT {json}`` line: the all-reduced FleetStats,
   a single-process recomputation of the whole fleet (single-phase only:
   the tail refines a cohort per shard, so two-phase results depend on the
   split by design) and, with ``--measure``, the throughput.

The printed stats crossed real process boundaries, so their equality with
the local recomputation shows that the mesh, the host-local shards and the
cross-process reduction work.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def fleet_arrays(batch: int) -> dict:
    """The seeded global fleet as host arrays, the same on every process:
    start, velocity, goal and 4 spheres a scenario."""
    rng = np.random.default_rng(42)
    obs = np.concatenate(
        [rng.normal(0, 4, (batch, 4, 3)), rng.uniform(0.3, 1.2, (batch, 4, 1))],
        axis=-1,
    ).astype(np.float32)
    pos = rng.normal(0, 2, (batch, 3)).astype(np.float32) + np.float32([0, 0, 5])
    vel = rng.normal(0, 1, (batch, 3)).astype(np.float32)
    goal = rng.normal(0, 5, (batch, 3)).astype(np.float32) + np.float32([0, 0, 5])
    return {"position": pos, "velocity": vel, "goal": goal, "obstacles": obs}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--coordinator", required=True, help="host:port of process 0")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl",
                    help="nccl: this process's cards; gloo: CPU devices")
    ap.add_argument("--local-devices", type=int, default=2)
    ap.add_argument("--global-batch", type=int, default=64)
    ap.add_argument("--horizon", type=int, default=10)
    ap.add_argument("--iterations", type=int, default=4)
    ap.add_argument("--measure", action="store_true",
                    help="also time chained solves (weak scaling)")
    ap.add_argument("--tail-iterations", type=int, default=0,
                    help="two-phase adaptive tail rounds (the shipping config uses 8); "
                         "the recomputation is skipped when > 0")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    from dart_planner_tpu_torch.parallel import distributed, scenario
    from dart_planner_tpu_torch.planning import se3_mpc

    if args.backend == "nccl":
        # each process its own cards: local rank r holds cards r*n .. r*n+n-1
        first = distributed.local_rank(args.process_id) * args.local_devices
        if first + args.local_devices > torch.cuda.device_count():
            raise RuntimeError(
                f"process {args.process_id} needs cards {first}..."
                f"{first + args.local_devices - 1}, {torch.cuda.device_count()} visible"
            )
        local = [torch.device("cuda", first + i) for i in range(args.local_devices)]
    else:
        local = [torch.device("cpu")] * args.local_devices
    distributed.initialize(args.coordinator, args.num_processes, args.process_id,
                           backend=args.backend,
                           device=local[0] if args.backend == "nccl" else None)
    try:
        world = torch.distributed.get_world_size()
        if world != args.num_processes:
            raise RuntimeError(f"world size {world}, expected {args.num_processes}")
        mesh = distributed.global_fleet_mesh(local)
        config = se3_mpc.SE3MPCConfig(
            prediction_horizon=args.horizon, max_iterations=args.iterations,
            tail_iterations=args.tail_iterations,
        )
        B = args.global_batch
        fleet = fleet_arrays(B)
        per = B // args.num_processes
        lo = args.process_id * per

        def problem(sl, device):
            return se3_mpc.make_problem(
                fleet["position"][sl], fleet["velocity"][sl], fleet["goal"][sl],
                obstacles=fleet["obstacles"][sl], config=config, device=device,
            )

        prob = distributed.host_local_problem(problem(slice(lo, lo + per), "cpu"), mesh)
        res, stats = scenario.solve_fleet(config, mesh, prob)
        out = {
            "process_id": args.process_id,
            "process_count": world,
            "global_devices": mesh.size,
            "stats": {name: float(getattr(stats, name)) for name in stats._fields},
        }
        if args.process_id == 0 and args.tail_iterations == 0:
            ref = se3_mpc.solve(config, problem(slice(0, B), local[0]))
            out["reference"] = {
                "total": float(B),
                "converged": float(ref.converged.sum()),
                "mean_cost": float(ref.cost.double().mean()),
                "max_grad_norm": float(ref.grad_norm.max()),
            }
        if args.measure:
            out["throughput"] = distributed.measure_throughput(
                config, mesh, prob, reps=args.reps
            )
        if args.process_id == 0:
            print("RESULT " + json.dumps(out), flush=True)
        return out
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
