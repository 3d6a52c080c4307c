#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``dart_planner_tpu_torch/csrc/``
with nvcc (one nvcc per source, started together) and holds each against
its plain PyTorch version on the card:

- kernel B2, the closed-loop tick block (``ops/cuda_rollout.py``): 2048
  episodes from non-trivial states with setpoints from a real plan, T=40,
  T=25 with 2 physics substeps, and a low failsafe trigger (phase 8);
- kernel B1, the fused solve (``ops/cuda_mpc.py``): at K=11 on the
  closed-loop fleet's first-replan problems (phase 3e), and at the solve
  bench's shapes (4096 scenarios, N=20, K=8 padded with 4 live spheres:
  one Newton round, convex and with every hinge on, in both curvature
  modes, with and without a per-scenario velocity cap; aggregates at the
  full budget; phase 3).

It drives both main paths of the port with the launch counts set to 0 just
before and read just after: the closed-loop Monte-Carlo with perceived
obstacle worlds (``sim.worlds.monte_carlo_with_worlds``, 2048 episodes of 60
replans, phase 9), and the two-phase ``planning.se3_mpc.solve`` with the
planner facade and the fast path (phases 4-6). Phases 7 and 10 time the
kernels against their plain versions with CUDA events, and the
Monte-Carlo's episodes/s on the host clock.

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
B_MC = 2048  # the Monte-Carlo fleet of the JAX package's bench
MC_START = (0.0, 0.0, 3.0)
MC_GOAL = (6.0, 3.0, 4.0)
# the JAX package's records on this fleet (BENCH_r05.json; docs/quality.md)
MC_RECORD = {"success": 0.9937, "crash": 0.0049, "rmse": 0.0382, "clearance": 1.066}


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


def random_tick_inputs(ctrl_cfg, B: int, T: int, seed: int, dev) -> tuple:
    """Non-trivial tick-block inputs on ``dev``: attitudes up to +-0.5 rad,
    omega ~ N(0, 2) rad/s, v ~ N(0, 2) m/s, integrals inside their caps,
    failsafe counts over 0-120, setpoints from a kernel solve around those
    states, and 3 true spheres per episode, the second of every 7th
    episode inactive."""
    import numpy as np
    import torch

    from dart_planner_tpu_torch.control import geometric
    from dart_planner_tpu_torch.ops import cuda_rollout, so3
    from dart_planner_tpu_torch.planning import se3_mpc
    from dart_planner_tpu_torch.sim import physics

    rng = np.random.default_rng(seed)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    pos = t(rng.normal(0, 2, (B, 3)) + [0, 0, 4])
    vel = t(rng.normal(0, 2, (B, 3)))
    rb = physics.RigidBodyState(
        position=pos, velocity=vel,
        rotation=so3.euler_to_rotmat(t(rng.uniform(-0.5, 0.5, (B, 3)))),
        angular_velocity=t(rng.normal(0, 2, (B, 3))),
    )
    caps = np.asarray(ctrl_cfg.max_integral_per_axis, np.float32)
    ctrl = geometric.ControllerState.zeros(ctrl_cfg, (B,), device=dev).replace(
        integral_vel_error=t(rng.uniform(-0.9, 0.9, (B, 3)) * caps),
        last_torque_saturated=t(rng.integers(0, 2, (B, 3))) > 0.5,
        failsafe_count=t(rng.integers(0, 121, B)).to(torch.int32),
        last_valid_thrust=t(rng.uniform(10.0, 20.0, B)),
    )
    mpc = se3_mpc.SE3MPCConfig(tail_iterations=0)
    goal = t(rng.normal(0, 4, (B, 3)) + [0, 0, 4])
    res = se3_mpc.solve(mpc, se3_mpc.make_problem(pos, vel, goal, config=mpc),
                        method="cuda")
    sp = cuda_rollout.setpoints_from_plan(
        res.positions, res.velocities, res.accelerations, T, 0.0025, mpc.dt
    )
    gw = torch.cat([goal.T, t(rng.normal(0, 1, (3, B))), t(np.zeros((2, B)))])
    spheres = torch.cat(
        [pos[:, None, :] + t(rng.normal(0, 1.5, (B, 3, 3))),
         t(rng.uniform(0.3, 0.9, (B, 3, 1)))], dim=-1,
    )
    mask = torch.ones((B, 3), dtype=torch.bool, device=dev)
    mask[::7, 1] = False
    return (cuda_rollout.pack_state(rb, ctrl), sp, gw.contiguous(),
            cuda_rollout.pack_obstacles(spheres, mask))


def tick_block_phase(dev) -> float:
    """Phase 8: kernel B2 against ``run_tick_block_plain`` on 2048 episodes.
    Returns the largest |kernel - plain| over the gated rows."""
    import torch

    from dart_planner_tpu_torch.ops import cuda_rollout
    from dart_planner_tpu_torch.sim import ClosedLoopConfig

    base = ClosedLoopConfig()
    B = B_MC
    worst = 0.0
    variants = (
        ("T=40", base.control, 40, 1),
        ("T=25 substeps=2", base.control, 25, 2),
        ("T=40 failsafe_trigger_count=10",
         base.control._replace(failsafe_trigger_count=10), 40, 1),
    )
    for i, (label, ctrl_cfg, T, sub) in enumerate(variants):
        S, (spp, spv, spa), gw, obs = random_tick_inputs(ctrl_cfg, B, T, 10 + i, dev)
        args = (ctrl_cfg, base.physics, base.control_dt, T, sub, S, spp, spv, spa,
                gw, obs)
        before = cuda_rollout.LAUNCHES
        ks, ka = cuda_rollout.run_tick_block(*args)
        torch.cuda.synchronize()
        check(cuda_rollout.LAUNCHES == before + 1,
              f"tick block {label}: LAUNCHES rose by "
              f"{cuda_rollout.LAUNCHES - before}, not 1")
        ps, pa = cuda_rollout.run_tick_block_plain(*args)
        check(bool(torch.isfinite(ks).all() and torch.isfinite(ka).all()),
              f"tick block {label}: non-finite kernel output")
        # the 0/1 rows (lt_sat, fcount) are exact compares at clip limits:
        # count the episodes where they part, and hold the float rows of
        # the others
        parted = (ks[21:25] != ps[21:25]).any(0)
        n_parted = int(parted.sum())
        check(n_parted <= 0.001 * B,
              f"tick block {label}: lt_sat/fcount differ in {n_parted} of {B} "
              "episodes (> 0.1%)")
        keep = ~parted
        errs = []
        for name, k, p in (("state", ks, ps), ("accumulator", ka, pa)):
            d = (k - p).abs()[:, keep]
            errs.append(float(d.max()))
            check(bool((d <= 1e-4 + 1e-4 * p.abs()[:, keep]).all()),
                  f"tick block {label}: {name} rows beyond atol 1e-4 + rtol 1e-4 "
                  f"(max |diff| {errs[-1]:.3g})")
        R = ks[9:18].T.reshape(B, 3, 3)
        ortho = float(
            (torch.einsum("bij,bkj->bik", R, R) - torch.eye(3, device=dev)).abs().max()
        )
        check(ortho <= 1e-5, f"tick block {label}: |R R^T - I| {ortho:.3g} > 1e-5")
        latched = int((ps[24] > ctrl_cfg.failsafe_trigger_count).sum())
        worst = max([worst] + errs)
        print(f"[8 tick block {label}] B={B}: max |kernel - plain| state "
              f"{errs[0]:.3g}, accumulators {errs[1]:.3g} (atol 1e-4 + rtol 1e-4); "
              f"lt_sat/fcount parted in {n_parted} of {B} episodes; failsafe "
              f"latched in {latched}; |R R^T - I| {ortho:.3g} (1e-5)", flush=True)
    return worst


def mc_config():
    """The Monte-Carlo configuration of the JAX package's bench (wind,
    sensor noise, in-flight sensing, unknown-space speed cap)."""
    from dart_planner_tpu_torch.sim import ClosedLoopConfig

    return ClosedLoopConfig(
        wind_mean=1.0, wind_std=0.5, sensor_noise_std=0.02, sense_radius=3.0,
        unknown_speed_cap=2.0,
    )


def summarize(res) -> dict:
    return {
        "success": float(res.success.float().mean()),
        "crash": float(res.crashed.float().mean()),
        "timeout": float((~res.success & ~res.crashed).float().mean()),
        "rmse": float(res.tracking_rmse.mean()),
        "clearance": float(res.min_obstacle_clearance.mean()),
    }


def closed_loop_phase(dev) -> dict:
    """Phase 9: the closed-loop main path at full size, with the launch
    counts set to 0 just before and read just after. The first replan's
    problems are kept for phase 3e."""
    import torch

    from dart_planner_tpu_torch.ops import cuda_mpc, cuda_rollout
    from dart_planner_tpu_torch.planning import se3_mpc
    from dart_planner_tpu_torch.sim import WorldConfig
    from dart_planner_tpu_torch.sim.worlds import monte_carlo_with_worlds

    cfg = mc_config()
    first = []
    solve = se3_mpc.solve

    def recording_solve(config, prob, u_init=None, *a, **kw):
        if not first:
            first.append((config, prob, u_init))
        return solve(config, prob, u_init, *a, **kw)

    gen = torch.Generator().manual_seed(0)
    se3_mpc.solve = recording_solve
    try:
        torch.cuda.synchronize()
        cuda_mpc.LAUNCHES = cuda_rollout.LAUNCHES = 0
        t0 = time.perf_counter()
        res, (tobs, _), (pobs, pmask) = monte_carlo_with_worlds(
            cfg, WorldConfig(), gen, B_MC, torch.tensor(MC_START, device=dev),
            torch.tensor(MC_GOAL, device=dev), method="auto",
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"B1": cuda_mpc.LAUNCHES, "B2": cuda_rollout.LAUNCHES}
    finally:
        se3_mpc.solve = solve
    check(launches == {"B1": cfg.num_replans, "B2": cfg.num_replans},
          f"closed loop: launches {launches}, not {cfg.num_replans} of each")
    for name, x in zip(res._fields, res):
        check(x.device.type == "cuda", f"closed loop: {name} is on {x.device}")
        if x.dtype.is_floating_point:
            check(bool(torch.isfinite(x).all()), f"closed loop: non-finite {name}")
    q = summarize(res)
    check(q["success"] >= 0.97, f"closed loop: success {q['success']:.4f} < 0.97")
    check(q["crash"] <= 0.015, f"closed loop: crash {q['crash']:.4f} > 0.015")
    check(q["rmse"] < 0.1, f"closed loop: tracking RMSE {q['rmse']:.4f} m >= 0.1")
    r = MC_RECORD
    print(f"[9 closed loop] monte_carlo_with_worlds B={B_MC}, 60 replans x 40 "
          f"ticks, method='auto': launches {launches}; success {q['success']:.4f} "
          f"(JAX record {r['success']}), crash {q['crash']:.4f} ({r['crash']}), "
          f"timeout {q['timeout']:.4f}, tracking RMSE {q['rmse']:.4f} m "
          f"({r['rmse']}), mean min clearance {q['clearance']:.4f} m "
          f"({r['clearance']}); perceived spheres {int(pmask.sum())} of "
          f"{pmask.numel()}; wall {wall:.2f} s with perception and the first "
          "call's warm-up", flush=True)
    return {"launches": launches, "quality": q, "first": first[0]}


def b1_k11_phase(first) -> float:
    """Phase 3e: one CG-2 round of kernel B1 against its plain loop on the
    closed-loop fleet's first-replan problems: K = 8 perceived + 3 sensed
    spheres, every hinge on, a per-scenario v_cap."""
    import torch

    from dart_planner_tpu_torch.common import frames
    from dart_planner_tpu_torch.ops import costs, cuda_mpc

    config, prob, u0 = first
    check(prob.obstacles.shape[-2] == 11 and prob.v_cap is not None,
          f"first replan: K={prob.obstacles.shape[-2]}, v_cap "
          f"{'set' if prob.v_cap is not None else 'missing'}; expected K=11 and a cap")
    gvec = frames.gravity_vector(frames.WorldFrame.ENU, config.gravity,
                                 device=prob.p0.device)
    act = hinge_activity(config, prob, u0, gvec)
    worst = 0.0
    for stage, n_gn in (("GN", 1), ("full", 0)):
        cfg_r = config._replace(max_iterations=1, cg_iterations=2,
                                gn_warmup_iterations=n_gn)
        kr = cuda_mpc.solve_thrusts_fused(cfg_r, prob, u0)
        pr = cuda_mpc.solve_thrusts_plain(cfg_r, prob, u0)
        own = costs.condensed_cost(kr[0], prob, config.weights, config.dt,
                                   config.mass, gvec)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(x).all()) for x in kr),
              f"K=11 {stage}: non-finite kernel output")
        du, dp, dv = (float((kr[i] - pr[i]).abs().max()) for i in (0, 2, 3))
        c_own = float(((kr[4] - own).abs() / own.abs()).max())
        for name, e in (("thrust", du), ("position", dp), ("velocity", dv)):
            check(e <= 2e-3, f"K=11 {stage}: {name} max |kernel - plain| {e:.3g} > 2e-3")
        check(c_own <= 1e-5, f"K=11 {stage}: cost vs own thrusts rel {c_own:.3g} > 1e-5")
        worst = max(worst, du)
        print(f"[3e B1 K=11 {stage}] B={prob.p0.shape[0]} first-replan problems, "
              f"CG-2, v_cap range {float(prob.v_cap.min()):.3f}-"
              f"{float(prob.v_cap.max()):.3f} m/s, active scenarios {act}: max |du| "
              f"{du:.3g} |dpos| {dp:.3g} |dvel| {dv:.3g} (atol 2e-3); cost rel vs own "
              f"thrusts {c_own:.3g} (rtol 1e-5)", flush=True)
    return worst


def device_profile(fn) -> dict:
    """One torch.profiler pass over ``fn()``: the host wall, the device's
    busy time (kernels and copies on the one stream, summed), its idle
    share, and the top device kernels and copies with their shares of the
    busy time. Only device-side entries are summed: a host op's self device
    time is that of the kernels it launched, which are entries of their
    own, so adding the host ops would count them twice."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    ops = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)),
                 key=dev_us, reverse=True)
    busy_us = sum(dev_us(e) for e in ops)
    top = [(e.key[:48], round(dev_us(e) / 1e3, 3), round(dev_us(e) / busy_us, 3))
           for e in ops[:6] if dev_us(e) > 0]
    return {"wall": wall, "busy": busy_us / 1e6, "idle": 1.0 - busy_us / 1e6 / wall,
            "top": top}


def closed_loop_times(dev, card: str) -> dict:
    """Phase 10: kernel B2 against its plain version at B=2048, T=40 (CUDA
    events), and the Monte-Carlo's episodes/s with the kernels and with the
    plain path (host clock after a synchronize; perception excluded, as the
    JAX package's bench excludes it), plus one profile of the kernel run."""
    import torch

    from dart_planner_tpu_torch.ops import cuda_rollout
    from dart_planner_tpu_torch.sim import WorldConfig, closed_loop, physics, worlds

    base = mc_config()
    S, (spp, spv, spa), gw, obs = random_tick_inputs(base.control, B_MC, 40, 20, dev)
    args = (base.control, base.physics, base.control_dt, 40, 1, S, spp, spv, spa, gw, obs)
    t_k = cuda_time_ms(lambda: cuda_rollout.run_tick_block(*args))
    t_p = cuda_time_ms(lambda: cuda_rollout.run_tick_block_plain(*args), reps=5)

    # the fleet, worlds and perception once, as set-up
    wc = WorldConfig()
    gen = torch.Generator().manual_seed(0)
    start = torch.tensor(MC_START, device=dev)
    goal = torch.tensor(MC_GOAL, device=dev)
    gen, states, goals = closed_loop.sample_fleet(gen, B_MC, start, goal)
    tobs, tmask = worlds.sample_worlds(wc, gen, B_MC, states.position, goals)
    pobs, pmask, cov = worlds.perceive_worlds(
        wc, tobs, tmask, states.position, goals,
        max_obstacles=base.mpc.max_obstacles, corridor_samples=wc.corridor_samples,
    )
    draws = torch.Generator().manual_seed(1)
    wind = physics.sample_wind(draws, (B_MC,), base.wind_mean, base.wind_std,
                                        device=dev)
    noise = base.sensor_noise_std * torch.randn(
        (base.num_replans, B_MC, 6), generator=draws).to(dev)

    def run_mc(method, n=B_MC):
        return closed_loop.simulate_episode(
            base, None, _take(states, n), goals[:n],
            obstacles=pobs[:n], obstacle_mask=pmask[:n], method=method,
            true_obstacles=tobs[:n], true_obstacle_mask=tmask[:n],
            corridor_observed=cov[:n], wind=wind[:n], noise=noise[:, :n],
        )

    def host_seconds(method, n=B_MC):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_mc(method, n)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, res

    host_seconds("auto")  # warm-up
    kernel_runs = [host_seconds("auto") for _ in range(3)]
    t_mc = statistics.median(t for t, _ in kernel_runs)
    q = summarize(kernel_runs[-1][1])
    t_torch, res_torch = host_seconds("torch")
    n_torch = B_MC
    if t_torch > 60.0:
        n_torch = 256
        t_torch, res_torch = host_seconds("torch", n_torch)
    qt = summarize(res_torch)
    prof = device_profile(lambda: run_mc("auto"))
    print(f"[10 times] ({card}) tick block B={B_MC} T=40 median CUDA-event ms: "
          f"kernel {t_k:.4f}, plain {t_p:.4f}", flush=True)
    print(f"[10 times] ({card}) Monte-Carlo B={B_MC}, perception excluded, host "
          f"clock: kernels {B_MC / t_mc:.1f} episodes/s (median of 3, "
          f"{t_mc:.3f} s a run; success {q['success']:.4f}, crash {q['crash']:.4f}); "
          f"plain path {n_torch / t_torch:.1f} episodes/s (one run of {n_torch} "
          f"episodes{', as 2048 passed 60 s' if n_torch != B_MC else ''}, "
          f"{t_torch:.3f} s; success {qt['success']:.4f}, crash {qt['crash']:.4f})",
          flush=True)
    print(f"[10 profile] ({card}) kernel Monte-Carlo run: host wall {prof['wall']:.3f} "
          f"s, device busy {prof['busy']:.3f} s, device idle share "
          f"{prof['idle']:.3f}; top device ops (ms, share of busy) {prof['top']}", flush=True)
    return {"ms": t_k, "plain_ms": t_p}


def _take(states, n: int):
    return states.replace(**{
        f: getattr(states, f)[:n]
        for f in ("timestamp", "position", "velocity", "attitude", "angular_velocity")
    })


def solver_phases(dev, card: str) -> dict:
    """Phases 3a-7: kernel B1 against its plain loop at the solve bench's
    shapes, the two-phase solve (the first slice's main path) with the
    launch count set to 0 just before and read just after, the planner
    facade, the fast path, and B1's times."""
    import numpy as np
    import torch

    from dart_planner_tpu_torch import DroneState
    from dart_planner_tpu_torch.common import frames
    from dart_planner_tpu_torch.ops import costs, cuda_mpc
    from dart_planner_tpu_torch.planning import PlannerFactory, se3_mpc
    from dart_planner_tpu_torch.runtime import rt_executor
    from dart_planner_tpu_torch.runtime.fast_path import (
        PlannerFastPath,
        measure_latency,
    )

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

    return {"launches": launches, "max_abs_err": max([err_u] + err_rounds),
            "ms": t_k, "plain_ms": t_p}


def run() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: no GPU to test")

    from dart_planner_tpu_torch.ops import _build, cuda_mpc, cuda_rollout

    dev = torch.device("cuda", 0)
    # the plain paths' reference arithmetic is exact fp32: no TF32
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
    cuda_rollout._library()
    built = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[2 build] {_build.library_path().name} in {built:.1f} s "
          f"(nvcc {_build.build_seconds:.1f} s); ptxas: {' | '.join(ptxas)}",
          flush=True)

    # -- 8. kernel B2 vs plain ----------------------------------------------
    err_b2 = tick_block_phase(dev)
    # -- 9. main path of this slice: the closed-loop Monte-Carlo ------------
    mc = closed_loop_phase(dev)
    # -- 3e. kernel B1 at K=11 on the fleet's first replan ------------------
    err_k11 = b1_k11_phase(mc["first"])
    # -- 3-7. kernel B1 at the solve bench, the first slice's main path -----
    b1 = solver_phases(dev, card)
    # -- 10. times of this slice ----------------------------------------------
    t_b2 = closed_loop_times(dev, card)

    return {
        "kernels": [
            {
                "name": "mpc_solve (B1, fused projected-Newton solve)",
                "route": "cuda",
                "source": cuda_mpc.SOURCE,
                "replaces": cuda_mpc.REPLACES,
                "launches": mc["launches"]["B1"],
                "launches_by_path": {"closed_loop": mc["launches"]["B1"],
                                     "solve": b1["launches"]},
                "max_abs_err": max(b1["max_abs_err"], err_k11),
                "ms": b1["ms"],
                "plain_ms": b1["plain_ms"],
            },
            {
                "name": "tick_block (B2, closed-loop control and physics ticks)",
                "route": "cuda",
                "source": cuda_rollout.SOURCE,
                "replaces": cuda_rollout.REPLACES,
                "launches": mc["launches"]["B2"],
                "launches_by_path": {"closed_loop": mc["launches"]["B2"]},
                "max_abs_err": err_b2,
                "ms": t_b2["ms"],
                "plain_ms": t_b2["plain_ms"],
            },
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
