#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Builds the hand-written CUDA solver kernel from
``dart_planner_tpu_torch/csrc/`` with nvcc, holds it against its plain
PyTorch version at the bench shapes (4096 scenarios, N=20, K=8 padded with
4 live spheres: thrusts, positions and velocities to 2e-3 after one Newton
round, convex and with every hinge on, in both curvature modes, with and
without a per-scenario velocity cap; aggregates at the full budget),
drives the port's main path (the two-phase
``planning.se3_mpc.solve``, the planner facade and the fast path) through
the kernel, and times kernel against plain loop with CUDA events.

Each phase prints one line. The line before the last is the per-kernel JSON
record; the last line is ``{"ok": true, "device": {...}}``, printed only
when every phase passed. Exits non-zero without it on any failure, or when
no CUDA device is visible. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

B_BENCH = 4096
LIVE_SPHERES = 4


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def bench_problem(se3_mpc, config, batch: int, seed: int, device):
    """The bench batch: 4 live spheres per scenario (padded to
    ``config.max_obstacles``), random start, velocity and goal."""
    import numpy as np

    rng = np.random.default_rng(seed)
    obs = np.concatenate(
        [
            rng.normal(0, 4, (batch, LIVE_SPHERES, 3)),
            rng.uniform(0.3, 1.2, (batch, LIVE_SPHERES, 1)),
        ],
        axis=-1,
    ).astype(np.float32)
    return se3_mpc.make_problem(
        rng.normal(0, 2, (batch, 3)).astype(np.float32) + np.float32([0, 0, 5]),
        rng.normal(0, 1, (batch, 3)).astype(np.float32),
        rng.normal(0, 5, (batch, 3)).astype(np.float32) + np.float32([0, 0, 5]),
        obstacles=obs,
        config=config,
        device=device,
    )


def hinge_activity(config, prob, u, gvec) -> dict:
    """Scenarios in which each hinge term of the cost is active at ``u``."""
    import torch

    from dart_planner_tpu_torch.ops import costs, dynamics

    w = config.weights
    pos, vel, _ = dynamics.rollout_linear(u, prob.p0, prob.v0, config.dt,
                                          config.mass, gvec)
    lat = torch.linalg.vector_norm(u[..., :2], dim=-1)
    terms = {
        "obstacle": costs.obstacle_penalty(pos, prob.obstacles, prob.obstacle_mask) > 0,
        "ground": (pos[..., 2] < w.ground_altitude).any(-1),
        "velocity": (vel.abs() > costs.effective_vmax(prob, w)).any(-1).any(-1),
        "tilt": (lat > w.tan_max_tilt * u[..., 2]).any(-1),
        "thrust_norm": (torch.linalg.vector_norm(u, dim=-1) > w.max_thrust_norm).any(-1),
    }
    return {name: int(active.sum()) for name, active in terms.items()}


def cuda_time_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run() -> dict:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: no GPU to test")

    from dart_planner_tpu_torch import DroneState
    from dart_planner_tpu_torch.common import frames
    from dart_planner_tpu_torch.ops import _build, costs, cuda_mpc
    from dart_planner_tpu_torch.planning import PlannerFactory, se3_mpc
    from dart_planner_tpu_torch.runtime import rt_executor
    from dart_planner_tpu_torch.runtime.fast_path import (
        PlannerFastPath,
        measure_latency,
    )

    dev = torch.device("cuda", 0)
    # the plain path's reference arithmetic is exact fp32: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. device ----------------------------------------------------------
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        raise SmokeFailure(f"nvidia-smi did not run: {e}") from e
    check(smi.returncode == 0 and smi.stdout.strip() != "",
          f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    print(f"[1 device] {kind} capability {cap[0]}.{cap[1]} "
          f"torch {torch.__version__} cuda {torch.version.cuda}; "
          "TF32 off for matmul and cuDNN", flush=True)

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    cuda_mpc._library()
    built = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[2 build] {_build.library_path().name} in {built:.1f} s "
          f"(nvcc {_build.build_seconds:.1f} s); ptxas: {' | '.join(ptxas)}",
          flush=True)

    # -- 3. kernel vs plain at the bench shapes ------------------------------
    base = se3_mpc.SE3MPCConfig()
    cfg_p1 = base._replace(tail_iterations=0)
    cfg_cvx = cfg_p1._replace(
        ground_weight=0.0, velocity_bound_weight=0.0, tilt_weight=0.0,
        thrust_norm_weight=0.0,
    )
    prob = bench_problem(se3_mpc, base, B_BENCH, 0, dev)

    # Convex parity. Thrusts are compared after one Newton round at CG-2,
    # a path that float32 rounding cannot branch; after the full CG-10
    # budget the converged plateau is flat enough that the plain loop on
    # the GPU and on the CPU already differ by ~1 N in thrust at equal
    # cost, so there the contract is the cost (rtol 1e-5).
    u0c = se3_mpc.initialize_thrusts(cfg_cvx, prob)
    cfg_one = cfg_cvx._replace(max_iterations=1, cg_iterations=2)
    k1 = cuda_mpc.solve_thrusts_fused(cfg_one, prob, u0c, use_obstacles=False)
    p1 = cuda_mpc.solve_thrusts_plain(cfg_one, prob, u0c, use_obstacles=False)
    kc = cuda_mpc.solve_thrusts_fused(cfg_cvx, prob, u0c, use_obstacles=False)
    pc = cuda_mpc.solve_thrusts_plain(cfg_cvx, prob, u0c, use_obstacles=False)
    torch.cuda.synchronize()
    err_u = float((k1[0] - p1[0]).abs().max())
    err_c1 = float(((k1[4] - p1[4]).abs() / p1[4].abs()).max())
    err_c = float(((kc[4] - pc[4]).abs() / pc[4].abs()).max())
    du_full = float((kc[0] - pc[0]).abs().max())
    for out in (k1, kc):
        check(all(bool(torch.isfinite(x).all()) for x in out),
              "convex: non-finite kernel output")
    check(err_u <= 2e-3, f"convex: thrust max |kernel - plain| {err_u:.3g} > 2e-3")
    check(err_c1 <= 1e-5, f"convex: one-round cost max rel diff {err_c1:.3g} > 1e-5")
    check(err_c <= 1e-5, f"convex: cost max rel diff {err_c:.3g} > 1e-5")
    print(f"[3a convex] B={B_BENCH}: one round at CG-2: max |du| {err_u:.3g} "
          f"(atol 2e-3), max cost rel {err_c1:.3g}; full budget: max cost rel "
          f"{err_c:.3g} (rtol 1e-5), max |du| {du_full:.3g} (not gated)",
          flush=True)

    u0 = se3_mpc.initialize_thrusts(cfg_p1, prob)
    gvec = frames.gravity_vector(frames.WorldFrame.ENU, base.gravity, device=dev)
    probv = prob._replace(
        v_cap=torch.full((B_BENCH,), 3.0, dtype=torch.float32, device=dev)
    )

    # Every hinge, both curvature modes, with and without a per-scenario
    # v_cap: one Newton round at CG-2 from the cold start, where the path
    # cannot branch, so a dropped or mis-scaled hinge gradient or curvature
    # block shows in the thrusts. The hinge counts say how many scenarios
    # each term is active in at the cold start.
    err_rounds = []
    for label, pr in (("static", prob), ("v_cap=3", probv)):
        act = hinge_activity(base, pr, u0, gvec)
        check(all(n > 0 for n in act.values()),
              f"one round {label}: some hinge inactive at the cold start {act}")
        for stage, n_gn in (("GN", 1), ("full", 0)):
            cfg_r = cfg_p1._replace(
                max_iterations=1, cg_iterations=2, gn_warmup_iterations=n_gn
            )
            kr = cuda_mpc.solve_thrusts_fused(cfg_r, pr, u0)
            pr_ = cuda_mpc.solve_thrusts_plain(cfg_r, pr, u0)
            own = costs.condensed_cost(kr[0], pr, base.weights, base.dt, base.mass, gvec)
            torch.cuda.synchronize()
            check(all(bool(torch.isfinite(x).all()) for x in kr),
                  f"one round {label} {stage}: non-finite kernel output")
            du, dp, dv = (float((kr[i] - pr_[i]).abs().max()) for i in (0, 2, 3))
            c_own = float(((kr[4] - own).abs() / own.abs()).max())
            c_pl = float(((kr[4] - pr_[4]).abs() / pr_[4].abs()).max())
            tag = f"one round {label} {stage}"
            check(du <= 2e-3, f"{tag}: thrust max |kernel - plain| {du:.3g} > 2e-3")
            check(dp <= 2e-3, f"{tag}: position max |kernel - plain| {dp:.3g} > 2e-3")
            check(dv <= 2e-3, f"{tag}: velocity max |kernel - plain| {dv:.3g} > 2e-3")
            check(c_own <= 1e-5, f"{tag}: cost vs own thrusts rel {c_own:.3g} > 1e-5")
            check(c_pl <= 1e-4, f"{tag}: cost vs plain rel {c_pl:.3g} > 1e-4")
            err_rounds.append(du)
            print(f"[3b {tag}] B={B_BENCH} CG-2, active scenarios {act}: max |du| "
                  f"{du:.3g} |dpos| {dp:.3g} |dvel| {dv:.3g} (atol 2e-3); cost rel "
                  f"vs own thrusts {c_own:.3g} (rtol 1e-5), vs plain {c_pl:.3g} "
                  "(rtol 1e-4)", flush=True)

    ko = cuda_mpc.solve_thrusts_fused(cfg_p1, prob, u0)
    po = cuda_mpc.solve_thrusts_plain(cfg_p1, prob, u0)
    c0 = costs.condensed_cost(u0, prob, base.weights, base.dt, base.mass, gvec)
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(x).all()) for x in ko)
    check(finite, "obstacles: non-finite kernel output")
    mk, mp = float(ko[4].mean()), float(po[4].mean())
    check(mk <= 1.05 * mp and mp <= 1.05 * mk,
          f"obstacles: mean cost kernel {mk:.6g} vs plain {mp:.6g} beyond 5%")
    n_up = int((ko[4] > c0 + 1e-3).sum())
    check(n_up == 0, f"obstacles: {n_up} scenarios end above their cold-start cost")
    close = float(((ko[0] - po[0]).abs() < 0.05).all(-1).all(-1).float().mean())
    check(close >= 0.5, f"obstacles: only {close:.3f} of scenarios within 0.05")
    print(f"[3c obstacles] mean cost kernel {mk:.6g} plain {mp:.6g}; "
          f"all <= cold start + 1e-3; thrusts within 0.05 on {close:.4f}",
          flush=True)

    kv = cuda_mpc.solve_thrusts_fused(cfg_p1, probv, u0)
    vmax_capped = float(kv[3].abs().amax())
    vmax_free = float(ko[3].abs().amax())
    check(bool(torch.isfinite(kv[4]).all()), "v_cap: non-finite costs")
    check(vmax_capped < vmax_free,
          f"v_cap: max |v| {vmax_capped:.3f} not below uncapped {vmax_free:.3f}")
    print(f"[3d v_cap=3] max |v| {vmax_capped:.3f} (uncapped {vmax_free:.3f})",
          flush=True)

    # -- 4. main path: two-phase solve through the kernel -------------------
    cuda_mpc.LAUNCHES = 0
    res = se3_mpc.solve(base, prob, method="auto")
    torch.cuda.synchronize()
    launches = cuda_mpc.LAUNCHES
    check(launches == 2, f"main path launched the kernel {launches} times, not 2")
    for name, x in zip(res._fields, res):
        if x is not None and x.dtype.is_floating_point:
            check(bool(torch.isfinite(x).all()), f"main path: non-finite {name}")
    lb, ub = base.thrust_bounds(device=dev)
    inside = bool(((res.thrusts >= lb - 1e-5) & (res.thrusts <= ub + 1e-5)).all())
    check(inside, "main path: thrusts outside thrust_bounds")
    conv = float(res.converged.float().mean())
    check(conv >= 0.90, f"main path: converged fraction {conv:.4f} < 0.90")
    traj = se3_mpc.extract_trajectory(base, res, 0.0)
    check(bool(torch.isfinite(traj.attitudes).all()
               and torch.isfinite(traj.body_rates).all()),
          "extract_trajectory: non-finite attitudes or rates")
    print(f"[4 main path] solve(method='auto') B={B_BENCH}: {launches} launches, "
          f"converged {conv:.4f}, mean cost {float(res.cost.mean()):.6g}",
          flush=True)
    # solution quality against a ground truth: the lower cost of a
    # 60-round CG-25 solve by the kernel and by the plain loop (the
    # measure of docs/quality.md; reported, not gated)
    cfg_gt = cfg_p1._replace(max_iterations=60, cg_iterations=25)
    u_qp = se3_mpc.initialize_thrusts(base, prob)
    gt = torch.minimum(
        cuda_mpc.solve_thrusts_fused(cfg_gt, prob, u_qp)[4],
        cuda_mpc.solve_thrusts_plain(cfg_gt, prob, u_qp)[4],
    )
    excess = ((res.cost - gt) / gt.abs()).float()
    conv_excess = excess[res.converged]
    print(f"[4 quality] excess over a 60-round CG-25 ground truth: p95 "
          f"{float(excess.quantile(0.95)):.3g} max {float(excess.max()):.3g}; "
          f"converged cohort p95 {float(conv_excess.quantile(0.95)):.3g}",
          flush=True)

    # -- 5. planner facade ---------------------------------------------------
    check(isinstance(PlannerFactory.create("se3_mpc"), se3_mpc.SE3MPCPlanner),
          "PlannerFactory('se3_mpc') is not the port's planner")
    planner = se3_mpc.SE3MPCPlanner(device="cuda")
    planner.add_obstacle(center=(2.5, 0.0, 2.0), radius=0.5)
    start, goal = (0.0, 0.0, 2.0), (5.0, 0.0, 3.0)
    state = DroneState.create(timestamp=0.0, position=start, device=dev)
    for i in range(5):
        before = cuda_mpc.LAUNCHES
        traj = planner.plan_trajectory(state, goal)
        check(cuda_mpc.LAUNCHES > before, f"replan {i} did not launch the kernel")
    final = traj.positions[-1].cpu().numpy()
    check(bool(np.isfinite(traj.positions.cpu().numpy()).all()), "planner: non-finite plan")
    d_end = float(np.linalg.norm(final - np.asarray(goal)))
    d_start = float(np.linalg.norm(np.asarray(start) - np.asarray(goal)))
    check(d_end < d_start, f"planner: end {d_end:.3f} m from goal, start {d_start:.3f}")
    print(f"[5 planner] 5 warm-started replans on cuda; last plan ends "
          f"{d_end:.3f} m from the goal (start {d_start:.3f} m)", flush=True)

    # -- 6. fast path ----------------------------------------------------------
    fp = PlannerFastPath(device="cuda")
    loop = rt_executor.create_control_loop(frequency_hz=200.0)
    loop.set_gains(
        kp_pos=[2.0, 2.0, 4.0], ki_pos=[0.0] * 3, kd_pos=[1.0] * 3,
        kp_att=[4.0] * 3, ki_att=[0.0] * 3, kd_att=[0.5] * 3,
    )
    loop.start()
    try:
        lat = measure_latency(fp, loop, n_replans=50)
    finally:
        loop.stop()
    print(f"[6 fast path] {type(loop).__name__}: planning p50 "
          f"{lat['planning_host_p50_ms']:.3f} ms p95 "
          f"{lat['planning_host_p95_ms']:.3f} ms, planner-to-actuator p95 "
          f"{lat['planner_to_actuator_p95_ms']:.3f} ms (host clock; {card})",
          flush=True)

    # -- 7. times: kernel vs plain, phase 1 ---------------------------------
    one = bench_problem(se3_mpc, base, 1, 1, dev)
    u1 = se3_mpc.initialize_thrusts(cfg_p1, one)
    t_k = cuda_time_ms(lambda: cuda_mpc.solve_thrusts_fused(cfg_p1, prob, u0))
    t_p = cuda_time_ms(lambda: cuda_mpc.solve_thrusts_plain(cfg_p1, prob, u0), reps=5)
    t_k1 = cuda_time_ms(lambda: cuda_mpc.solve_thrusts_fused(cfg_p1, one, u1))
    t_p1 = cuda_time_ms(lambda: cuda_mpc.solve_thrusts_plain(cfg_p1, one, u1), reps=5)
    t_2k = cuda_time_ms(lambda: se3_mpc.solve(base, prob, u0, method="cuda"))
    t_2p = cuda_time_ms(lambda: se3_mpc.solve(base, prob, u0, method="torch"), reps=3)
    print(f"[7 times] median CUDA-event ms ({card}): phase-1 solve "
          f"B={B_BENCH} kernel {t_k:.4f} plain {t_p:.4f}; "
          f"B=1 kernel {t_k1:.4f} plain {t_p1:.4f}; two-phase solve() "
          f"B={B_BENCH} kernel {t_2k:.4f} plain {t_2p:.4f}", flush=True)

    return {
        "kernels": [
            {
                "name": "mpc_solve (B1, fused projected-Newton solve)",
                "route": "cuda",
                "source": cuda_mpc.SOURCE,
                "replaces": cuda_mpc.REPLACES,
                "launches": launches,
                "max_abs_err": max([err_u] + err_rounds),
                "ms": t_k,
                "plain_ms": t_p,
            }
        ]
    }


def main() -> int:
    try:
        record = run()
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    import torch

    print(json.dumps(record), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
