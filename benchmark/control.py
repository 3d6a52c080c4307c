#!/usr/bin/env python3
"""Readings for the limits of ``correct``: the numbers the comparison works
out on many seeds, for the program and for its control, in one process:

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 --seconds 3
    python3 benchmark/control.py --workload <name> --seeds 1,2,3 --seconds 3 --control

With ``--control`` the plain reference (``benchmark/reference``) is put in
the program's place and its products computed in TF32, the nearest
precision below the configurations' exact fp32: the solve, the trajectory
extraction, the closed loop's setpoints and its tick block. Each seed's numbers are printed
as one JSON line. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from benchmark.lib.harness import run_cell  # noqa: E402
from benchmark.reference import loop as ref_loop  # noqa: E402
from benchmark.reference import solve as ref  # noqa: E402

ref.exact_matmul = ref.matmul


@contextlib.contextmanager
def tf32():
    """The reference's products in TF32 for the span of one call. Allowing
    TF32 alone changes nothing here: for these skinny products cuBLAS keeps
    its fp32 FMA kernels. So the operands are rounded to TF32 as a tensor
    core rounds them (``reference.solve.tf32_matmul``)."""
    ref.matmul = ref.tf32_matmul
    try:
        yield
    finally:
        ref.matmul = ref.exact_matmul


def put_reference_in_place(config: dict) -> None:
    """Replace the program's solve, extraction, setpoints and tick block by
    the reference, computed with TF32 on."""
    from dart_planner_tpu_torch.common.types import Trajectory
    from dart_planner_tpu_torch.ops import cuda_rollout
    from dart_planner_tpu_torch.planning import se3_mpc

    c = ref.SolverConfig.from_dict(config["solver"])

    def solve(cfg, prob, u_init=None, use_obstacles=True, method="auto"):
        with tf32():
            r = ref.solve(c, ref.Problem(*prob), u_init)
        return se3_mpc.SolveResult(r.thrusts, r.positions, r.velocities, r.accelerations,
                                   r.cost, r.converged, None, None)

    def extract_trajectory(cfg, result, start_time):
        with tf32():
            att, rates, tmag, ts = ref.extract(c, result.thrusts, start_time)
        return Trajectory(timestamps=ts, positions=result.positions,
                          velocities=result.velocities, accelerations=result.accelerations,
                          attitudes=att, body_rates=rates, thrusts=tmag, yaws=att[..., 2],
                          yaw_rates=rates[..., 2])

    def setpoints_from_plan(positions, velocities, accelerations, T, control_dt, mpc_dt):
        with tf32():
            return tuple(ref_loop.setpoints(T, control_dt, mpc_dt, positions, velocities,
                                            accelerations))

    def run_tick_block(control_cfg, physics_cfg, control_dt, T, substeps, S, spp, spv, spa,
                       gw, obs=None):
        with tf32():
            return ref_loop.tick_block(control_cfg._asdict(), physics_cfg._asdict(), control_dt,
                                       T, substeps, S, spp, spv, spa, gw, obs)

    se3_mpc.solve = solve
    se3_mpc.extract_trajectory = extract_trajectory
    cuda_rollout.setpoints_from_plan = setpoints_from_plan
    cuda_rollout.run_tick_block = run_tick_block


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--check-replans", default=None,
                    help="lo,hi: draw the fleet's checked replans from [lo, hi) (the plain "
                         "reference in the program's place replans slowly)")
    args = ap.parse_args(argv)
    from benchmark.lib.harness import cell_spec

    if args.control:
        put_reference_in_place(cell_spec(args.workload)["config"])
    overrides = None
    if args.check_replans:
        overrides = {"check_replans": [int(x) for x in args.check_replans.split(",")]}
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run_cell(args.workload, seed, args.seconds, False, torch.device("cuda", 0),
                     overrides)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "correct": r["correct"], "metrics": r["metrics"],
                          "numbers": r["numbers"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
