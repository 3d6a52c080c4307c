#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py
    python3 chip_smoke.py --baseline build/baseline/tick_block.cu

Builds the hand-written CUDA kernels from ``dart_planner_tpu_torch/csrc/``
with nvcc (one nvcc per source, started together) and holds each against
its plain PyTorch version on the card:

- kernel B2, the closed-loop tick block (``ops/cuda_rollout.py``): 2048
  episodes from non-trivial states with setpoints from a real plan, T=40,
  T=25 with 2 physics substeps, a low failsafe trigger, and no spheres
  (phase 8); figure-8's B=1, T=8, K=0 (phase 12);
- kernel B1, the fused solve (``ops/cuda_mpc.py``): at K=11 on the
  closed-loop fleet's first-replan problems (phase 3e), and at the solve
  bench's shapes (4096 scenarios, N=20, K=8 padded with 4 live spheres:
  one Newton round, convex and with every hinge on, in both curvature
  modes, with and without a per-scenario velocity cap; aggregates at the
  full budget; phase 3); at the fleet's 131,072 scenarios and its tail's
  32,768 (one Newton round in every scenario; the whole fleet against the
  plain path; phase 11); at figure-8's B=1 with per-step goals (phase 12).

It drives both main paths of the port with the launch counts set to 0 just
before and read just after: the closed-loop Monte-Carlo with perceived
obstacle worlds (``sim.worlds.monte_carlo_with_worlds``, 2048 episodes of 60
replans, phase 9), and the two-phase ``planning.se3_mpc.solve`` with the
planner facade and the fast path (phases 4-6); and this slice's paths: the
scenario fleet of 131,072 through ``parallel.solve_fleet`` with its stats
all-reduced over an NCCL group of one process (phase 11), the BASELINE
scenarios hover-to-waypoint, mapper navigation and figure-8 tracking at its
defaults, with its first 20 replans against the plain path (phase 12), and
the resumable sweep, stopped after a chunk and resumed (phase 13); and the
three-layer mission stack (phase 14): the hardware mission runner over the
simulated vehicle at the deployment's settings (400 Hz control, 50 Hz
replans through B1 at the default solver; plan and vehicle-tick times by
CUDA events, the control task's achieved rate and overruns, the device's
idle share, 14a), the three-layer loop of L1 goals, L2 plans, the smoother
and the real-time executor (14b), and B1 on the mission's first replans
against the plain path, the batched smoother and the EKF fleet on the card
against the CPU (14c); and the edge<->cloud deployment (phase 15): the
cloud's ``main`` in a process of its own on the card (``SE3MPCConfig()``,
the 128x128x64 voxel map, 360-ray lidar, the demo mission; every plan
through B1) serving the edge, flown in this process at ``EdgeConfig()``
(200 Hz control, 10 Hz comms) over ZMQ on tcp loopback, or, without
pyzmq, both in this process linked by an in-process pair that carries the
signed bytes through the port's request handling (plan and tick times by
CUDA events, round trips on the host clock, the control task's achieved
rate, the idle share, 15a; the cloud entered through the port's CLI,
``cli.main(["run", "--mode=cloud", ...])``, which loads the frozen config
and serves ``/metrics``, scraped once); the onboard fallback through
NOMINAL, DEGRADED and AUTONOMOUS with its replans through B1, and the
minimal takeoff (15b); and B1 on the cloud's first plans against the plain
path (15c); and the front door (phase 16): the DI container's planner,
built from the frozen config, planning through B1 against the plain path,
and under a ``DART_PREDICTION_HORIZON=10`` override (16a), and the web
demo's ``DemoEngine`` on the card, started and stopped through its REST
handler, 10 replans of ``precision_landing`` through B1, its first
against the plain path (16b); and the last of the port (phase 17): a
mission through ``start_mission`` over the MAVLink adapter on the card
and a scripted link at the default ``MissionConfig`` (400 Hz / 50 Hz),
every plan through B1, the first against the plain path, the external
control tick timed by CUDA events (17a), the link's heartbeat lost and
the mission grounded (17b); the secure channel's RS256-gated upload of a
B1 plan to the simulated vehicle on the card, against the plain path, and
its denials, emergency-stop latch and re-authentication (17c); the AirSim
adapter on the card against the CPU's, bit for bit (17d); and the process
loop run after CUDA started here, fed a state read from the card (17e); and
kernel B1 past 64 horizon steps (phase 18, after 17e's fork): one Newton
round at N = 65, 80, 100 and 128 against the plain version, scenario by
scenario (18a), the two-phase solve at N = 80 and 100 against the plain
path within twice the plain path's own spread across devices, and two
and three rounds against the plain loop, scenario by scenario beside the
plain loop's own spread (18b), the DI planner
under ``DART_PREDICTION_HORIZON`` = 80 and 100 (18c), and B1's times at N =
20, 40, 80 and 100, B=4096 and B=1, with its ptxas registers and spills for
each steps-a-lane instantiation (18d); a fork, then a cold start at a
horizon not cached before and its solve under a watchdog (18e, ROADMAP
C.23); B1 past 128 steps, one instantiation for five or more steps a lane
(18f, C.24): one Newton round and ``solve()`` at N = 129, 160, 256 and 769
(the smallest N whose arena spills to global scratch) at B=64, the
two-phase solve at N=160, B=4096 within twice the plain path's own spread,
its ptxas lines and times; and the convergence diagnostic
(``scripts/diag_convergence_torch.py``) at N = 20, 80 and 100 with its
rows, its ship row at N=20 against phase 4's converged share (phase 19);
and the nine examples of ``examples_torch/``, each ``main()`` with no
device at the JAX examples' sizes, their launches of both kernels counted
around each call, batched_solves, monte_carlo_fleet and fleet_sharding
held against their plain paths on the same inputs and the three-layer
mission's first plans re-solved on the plain path (phase 20); and the
eight diagnostics of ``scripts/*_torch.py`` at the JAX scripts' sizes
through their row functions (phase 21): the weak-scaling table's NCCL
row, the Newton decrement at N = 20 and 100, the tail, the stuck scenario
and the fixes on the bench batch for the plain path and B1, and the
timeout census, the goal-clamp sweep and the unknown-space cap sweep on
one 2048-episode fleet and its draws through B1 and B2, the shipping row
also on the plain path; and the port's benchmark (phase 22),
``python -m dart_planner_tpu_torch.apps.cli bench``, which runs
``bench_torch.py``'s five sections at bench.py's sizes in a process of its
own, its record checked: every section present, no error, the latency
gate passed on the native 400 Hz loop, the Monte-Carlo within phase 9's
limits, each section's launches of both kernels as reckoned from the code.
Phases 7 and 10 time the kernels against their plain versions with CUDA
events, and the Monte-Carlo's episodes/s on the host clock; phase 10 also reads the SM
clock under load and prints kernel B2's latency floor beside its bound (the
floor's cycles a tick are reckoned from assumed instruction latencies, so it
stays out of the per-kernel JSON record).
With ``--baseline SRC``, phase 10 also builds SRC, an earlier version of
kernel B2's ``csrc/tick_block.cu`` with the same C interface, into its own
library and times it turn by turn against the package's kernel (old, new,
new, old; with the wrapper and alone), and prints the largest |new - old|
over the state and accumulator rows.

Each phase prints one line, and the script its total seconds before the
per-kernel JSON record. The line before the last is the per-kernel JSON
record; the last line is ``{"ok": true, "device": {...}}``, printed only
when every phase passed. Exits non-zero without it on any failure, or when
no CUDA device is visible. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import math
import pathlib
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
B_FLEET = 131_072  # the fleet shard of the JAX package's bench (BASELINE config 5)
# the JAX package's figure8_tracking() at its defaults (N=20, 600 replans of 8
# ticks), float32, run on a CPU with JAX_PLATFORMS=cpu: the tracking RMSE and
# max error in m. Quality figures: they do not depend on the hardware.
JAX_FIG8_RMSE = 0.2867344319820404
JAX_FIG8_MAX_ERROR = 0.4086516499519348
SWEEP_EPISODES, SWEEP_CHUNK = 4096, 2048
# the share of a fleet's elements (scenarios, for the cost) that one CG-2
# round of B1 may part from the plain loop beyond phase 3's limits
FLEET_ROUND_OUTLIERS = 1e-4

# NVIDIA H100 SXM peaks (data sheet, at a 700 W power limit): HBM3 bytes/s
# and fp32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# a precise sqrtf or division: one SFU op and its Newton refinement,
# counted as 8 fp32 operations
SQRT_DIV_OPS = 8
# kernel B2's fp32 operations per episode and control tick, reckoned from
# csrc/tick_block.cu (the controller, one substep of the plant, the metrics
# against K spheres): ~600 at K=3
B2_OPS_PER_TICK = 600
# the cycles of the longest dependent path through one tick of kernel B2
# with one substep, reckoned from csrc/tick_block.cu's code: 3 precise
# square roots (f_norm, n1, theta) at 33 cycles each (MUFU.RSQ and three
# dependent refinements), 4 precise divisions (inv_f, 1 / n1, the angular
# acceleration, sin(theta) / theta) at 38 (MUFU.RCP and five dependent
# FMAs), one sincosf at 65 (range reduction and polynomial) and 51
# dependent fp32 adds, multiplies, FMAs, min/max, compares and selects at 4
# cycles each; and what each further substep adds (the angular
# acceleration, theta, sincosf, both Rodrigues coefficients, E and R E)
B2_CHAIN_CYCLES = 3 * 33 + 4 * 38 + 65 + 51 * 4
B2_SUBSTEP_CYCLES = 33 + 2 * 38 + 65 + 16 * 4


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


def b1_one_round(cfg_r, prob, u0, gvec) -> dict:
    """One launch of kernel B1 against ``solve_thrusts_plain`` on the same
    inputs, at a budget float32 rounding cannot branch (``cfg_r``: one
    Newton round at CG-2), in every scenario: the largest |kernel - plain|
    of the thrusts, positions and velocities and the share of their
    elements beyond 2e-3; the largest relative cost difference to the
    plain loop's and the share of scenarios beyond 1e-4; the largest
    relative difference of the kernel's cost to its own thrusts' exact
    cost. Checked by :func:`check_round`."""
    import torch

    from dart_planner_tpu_torch.ops import costs, cuda_mpc

    kr = cuda_mpc.solve_thrusts_fused(cfg_r, prob, u0)
    pr = cuda_mpc.solve_thrusts_plain(cfg_r, prob, u0)
    own = costs.condensed_cost(kr[0], prob, cfg_r.weights, cfg_r.dt, cfg_r.mass, gvec)
    torch.cuda.synchronize()
    e = {"finite": all(bool(torch.isfinite(x).all()) for x in kr)}
    for name, i in (("du", 0), ("dp", 2), ("dv", 3)):
        d = (kr[i] - pr[i]).abs()
        e[name], e[name + "_over"] = float(d.max()), float((d > 2e-3).float().mean())
    rel = (kr[4] - pr[4]).abs() / pr[4].abs()
    e["c_pl"], e["c_pl_over"] = float(rel.max()), float((rel > 1e-4).float().mean())
    e["c_own"] = float(((kr[4] - own).abs() / own.abs()).max())
    return e


def check_round(tag: str, e: dict, outliers: float = 0.0) -> None:
    """Thrusts, positions and velocities to 2e-3 and the cost to 1e-4 of
    the plain loop's, in every element and scenario; or, with
    ``outliers`` > 0, in all but that share of them, with every element
    within 5x those limits (float32 rounding in CG-2's two steps has a
    tail that grows with the batch, while a misplaced launch or index
    parts whole blocks of scenarios by newtons). The kernel's cost to 1e-5
    of its own thrusts' exact cost everywhere."""
    check(e["finite"], f"{tag}: non-finite kernel output")
    for name, key in (("thrust", "du"), ("position", "dp"), ("velocity", "dv"),
                      ("cost rel vs plain", "c_pl")):
        lim = 1e-4 if key == "c_pl" else 2e-3
        check(e[key + "_over"] <= outliers and e[key] <= (5 * lim if outliers else lim),
              f"{tag}: {name} beyond {lim:g} on a share {e[key + '_over']:.3g} "
              f"(allowed {outliers:g}), max {e[key]:.3g}")
    check(e["c_own"] <= 1e-5, f"{tag}: cost vs own thrusts rel {e['c_own']:.3g} > 1e-5")


def round_summary(e: dict) -> str:
    return (f"max |du| {e['du']:.3g} |dpos| {e['dp']:.3g} |dvel| {e['dv']:.3g} (2e-3; "
            f"share beyond {e['du_over']:.3g} / {e['dp_over']:.3g} / {e['dv_over']:.3g}); "
            f"cost rel vs plain max {e['c_pl']:.3g} (1e-4; share beyond "
            f"{e['c_pl_over']:.3g}), vs own thrusts {e['c_own']:.3g} (1e-5)")


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


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the fp32 operations over the fp32 peak, and which it is."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def b1_bound(config, prob) -> tuple[float, str]:
    """Bound of one launch of kernel B1 on ``prob``, counted from the work
    the function needs, per valid horizon step, from csrc/mpc_solve.cu: one
    add per element for each prefix or suffix sum of a structured map (S_p
    is two sums, S_v one), an FMA as 2 operations, a precise sqrt or
    division as SQRT_DIV_OPS, the sphere terms only for live spheres (the
    mask's count). Every CG step of the budget is counted: the kernel's
    exit on negative curvature is not observed. Bytes: each input read
    once, each output written once, the constant block read once."""
    from dart_planner_tpu_torch.ops import cuda_mpc

    N = config.prediction_horizon
    B = prob.p0.numel() // 3
    K = float(prob.obstacle_mask.sum()) / B  # live spheres a scenario
    q = SQRT_DIV_OPS
    n_gn, n_full = cuda_mpc.stage_counts(config)
    A = len(config.line_search_alphas)
    rollout = 24  # 2 prefix sums and the combine, 3 axes, plus C_pos, C_vel
    cost = 65 + K * (14 + q) + (9 + q) + (10 + q)  # quadratic, hinges, spheres
    cg_step = 168  # 2 prefix + 2 suffix sums, blocks, pull-back, dots, updates

    def round_ops(full: bool) -> float:
        spheres = K * (48 + 4 * q if full else 42 + 3 * q)
        tilt = 29 + 4 * q if full else 23 + 3 * q
        tnorm = 35 + 5 * q if full else 26 + 4 * q
        return (rollout + 46 + spheres + cost + 21 + 18 + tilt + tnorm + 18
                + (35 + 3 * q) + 15 + config.cg_iterations * cg_step
                + A * (36 + cost))

    ops = B * N * (n_gn * round_ops(False) + n_full * round_ops(True) + rollout + cost)
    Kp = prob.obstacles.shape[-2]
    floats_in = B * (N * 3 + 6 + N * 3 + Kp * 5 + (prob.v_cap is not None))
    floats_out = B * (3 * N * 3 + 2)
    n_bytes = 4 * (floats_in + floats_out + cuda_mpc.constants_host(config).numel())
    return bound_ms(n_bytes, ops)


def b2_bound(B: int, T: int, substeps: int, *tensors) -> tuple[float, str]:
    """Bound of one launch of kernel B2: the bytes of its inputs and
    outputs, and B2_OPS_PER_TICK per episode, tick and substep."""
    n_bytes = sum(4 * t.numel() for t in tensors)
    return bound_ms(n_bytes, B * T * substeps * B2_OPS_PER_TICK)


def b2_floor_ms(T: int, substeps: int, sm_mhz: float) -> float:
    """Latency floor of one launch of kernel B2: T ticks of one tick's
    dependent chain at the SM clock ``sm_mhz``."""
    cycles = B2_CHAIN_CYCLES + (substeps - 1) * B2_SUBSTEP_CYCLES
    return T * cycles / (sm_mhz * 1e3)


def sm_clock_mhz(fn, seconds: float = 1.5) -> float:
    """The SM clock in MHz while ``fn()`` runs back to back for ``seconds``:
    the median of nvidia-smi's readings every 50 ms over that window."""
    import torch

    proc = subprocess.Popen(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
         "-lms", "50"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
    )
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out = proc.communicate(timeout=60)[0]
    readings = [float(x) for x in out.split() if x.replace(".", "", 1).isdigit()]
    check(len(readings) > 0, "nvidia-smi gave no SM clock reading")
    return statistics.median(readings)


def load_baseline(source: pathlib.Path):
    """Build ``source`` (an earlier version of csrc/tick_block.cu with the
    same C interface) into its own library under build/ and bind it."""
    from dart_planner_tpu_torch.ops import _build, cuda_rollout

    out = _build.BUILD_DIR.parent / "baseline" / "libtick_block_baseline.so"
    _build.compile_library([source], out)
    return cuda_rollout.bind(ctypes.CDLL(str(out)))


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
    """Phase 8: kernel B2 against ``run_tick_block_plain`` on 2048 episodes,
    with 3 spheres an episode and with none (K=0, the sweep's launches).
    Returns the largest |kernel - plain| over the gated rows."""
    import torch

    from dart_planner_tpu_torch.ops import cuda_rollout
    from dart_planner_tpu_torch.sim import ClosedLoopConfig

    base = ClosedLoopConfig()
    B = B_MC
    worst = 0.0
    variants = (
        ("T=40", base.control, 40, 1, True),
        ("T=25 substeps=2", base.control, 25, 2, True),
        ("T=40 failsafe_trigger_count=10",
         base.control._replace(failsafe_trigger_count=10), 40, 1, True),
        ("T=40 K=0 (the sweep's shape)", base.control, 40, 1, False),
    )
    for i, (label, ctrl_cfg, T, sub, spheres) in enumerate(variants):
        S, (spp, spv, spa), gw, obs = random_tick_inputs(ctrl_cfg, B, T, 10 + i, dev)
        obs = obs if spheres else None
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


def _device_us(event) -> float:
    """An averaged profiler entry's own device time, in us."""
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def convex_tie_phase(dev) -> None:
    """Phase 3f: the JAX package's small convex regime (16 scenarios, N=8,
    CG-10, the hinges off; ROADMAP C.9), kernel B1 against its plain loop
    after each of rounds 1-4: where the two part by more than 2e-3 N, and
    their costs there. Reported; ``test_cuda_kernel_convex_parity`` in
    tests/test_torch_cuda_mpc.py holds it."""
    import numpy as np

    from dart_planner_tpu_torch.ops import cuda_mpc
    from dart_planner_tpu_torch.planning import se3_mpc

    cfg = se3_mpc.SE3MPCConfig(
        prediction_horizon=8, cg_iterations=10, tail_iterations=0, ground_weight=0.0,
        velocity_bound_weight=0.0, tilt_weight=0.0, thrust_norm_weight=0.0,
    )
    rng = np.random.default_rng(0)  # the test's draws: spheres (unused), then states
    rng.normal(0, 4, (16, 3, 3)), rng.uniform(0.3, 1.2, (16, 3, 1))
    p0 = rng.normal(0, 2, (16, 3)).astype(np.float32) + np.float32([0, 0, 5])
    v0 = rng.normal(0, 1, (16, 3)).astype(np.float32)
    goal = rng.normal(0, 3, (16, 3)).astype(np.float32) + np.float32([0, 0, 5])
    prob = se3_mpc.make_problem(p0, v0, goal, config=cfg, device=dev)
    u0 = se3_mpc.initialize_thrusts(cfg, prob)
    rounds = []
    for r in range(1, 5):
        c = cfg._replace(max_iterations=r)
        k = cuda_mpc.solve_thrusts_fused(c, prob, u0, False)
        p = cuda_mpc.solve_thrusts_plain(c, prob, u0, False)
        du = (k[0] - p[0]).abs().amax((-1, -2))
        apart = [f"scenario {i}: {float(du[i]):.3g} N, cost kernel {float(k[4][i]):.8g} "
                 f"plain {float(p[4][i]):.8g}" for i in (du > 2e-3).nonzero().flatten().tolist()]
        rounds.append(f"round {r} max |du| {float(du.max()):.3g}"
                      + (f" ({'; '.join(apart)})" if apart else ""))
    print(f"[3f convex tie] N=8, CG-10, 16 scenarios: {', '.join(rounds)}", flush=True)


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
    return profile_summary(prof, wall)


def profile_summary(prof, wall: float) -> dict:
    """A finished torch.profiler pass over ``wall`` seconds of the host
    clock: the device's busy time (its own entries summed), idle share and
    top kernels and copies, as :func:`device_profile` reports them."""
    from torch.autograd import DeviceType

    ops = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)),
                 key=_device_us, reverse=True)
    busy_us = sum(_device_us(e) for e in ops)
    top = [(e.key[:48], round(_device_us(e) / 1e3, 3), round(_device_us(e) / busy_us, 3))
           for e in ops[:6] if _device_us(e) > 0]
    return {"wall": wall, "busy": busy_us / 1e6, "idle": 1.0 - busy_us / 1e6 / wall,
            "top": top}


class _EventTimedLibrary:
    """A kernel library whose ``mpc_solve_launch`` is bracketed by two CUDA
    events on the launch's stream: their elapsed time is the kernel's own
    device time, without the wrapper's host work and copies."""

    def __init__(self, lib):
        self.lib, self.pairs = lib, []

    def mpc_solve_launch(self, *args):
        import torch

        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        err = self.lib.mpc_solve_launch(*args)
        end.record()
        self.pairs.append((start, end))
        return err

    def __getattr__(self, name):
        return getattr(self.lib, name)


def b1_alone_ms(config, prob, u0, reps: int = 7) -> float:
    """Median device time of kernel B1 alone on ``prob`` by CUDA events
    around each launch (after a warm-up launch), through the wrapper's own
    flattening (``cuda_mpc.run_library``, whose launches count in
    ``cuda_mpc.LAUNCHES`` as every other path's do). Late in this script's
    run torch.profiler has held 4 of 5 launches' records, and then none, so
    phase 18d does not rely on it."""
    import torch

    from dart_planner_tpu_torch.ops import cuda_mpc

    timed = _EventTimedLibrary(cuda_mpc._library())
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(reps + 1):
        cuda_mpc.run_library(lambda: timed, config, prob, u0, True, stream)
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in timed.pairs[1:])


def kernel_device_ms(fn, kernel: str, reps: int = 5) -> float:
    """Device time a call of ``fn()`` spends in the kernels whose name holds
    ``kernel`` (the kernel alone, without the wrapper's host work and torch
    ops), by torch.profiler over ``reps`` calls after a warm-up call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(_device_us(e) for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and kernel in e.key)
    check(us > 0, f"profile: no device time in a kernel named {kernel}")
    return us / reps / 1e3


def tick_block_turns(args, baseline) -> str:
    """Kernel B2 against an earlier build of it (``baseline``, bound by
    ``cuda_rollout.bind``) on the same inputs, turn by turn: old, new, new,
    old, with the wrapper (CUDA events) and alone (torch.profiler), and the
    largest |new - old| over the state and accumulator rows."""
    import torch

    from dart_planner_tpu_torch.ops import cuda_rollout

    def new():
        return cuda_rollout.run_tick_block(*args)

    def old():
        return cuda_rollout.launch_tick_block(baseline, *args)

    wrapped = [cuda_time_ms(fn) for fn in (old, new, new, old)]
    alone = [kernel_device_ms(fn, "tick_block_kernel") for fn in (old, new, new, old)]
    (ns, na), (os_, oa) = new(), old()
    torch.cuda.synchronize()
    d_state, d_acc = float((ns - os_).abs().max()), float((na - oa).abs().max())
    n_diff = int((ns != os_).sum()) + int((na != oa).sum())
    rows = (ns != os_).any(1).nonzero().flatten().tolist()

    def turns(t):
        return (f"{' / '.join(f'{x:.4f}' for x in t)} ms, speed-up "
                f"{(t[0] + t[3]) / (t[1] + t[2]):.2f}x")

    return (f"old / new / new / old with the wrapper {turns(wrapped)}; alone "
            f"{turns(alone)}; max |new - old| state {d_state:.3g}, accumulators "
            f"{d_acc:.3g}, {n_diff} of {ns.numel() + na.numel()} values differ (state "
            f"rows {rows})")


def closed_loop_times(dev, card: str, baseline=None) -> dict:
    """Phase 10: kernel B2 against its plain version at B=2048, T=40 (CUDA
    events), its bound and latency floor (the SM clock read while it runs),
    and the Monte-Carlo's episodes/s with the kernels and with the plain
    path (host clock after a synchronize; perception excluded, as the JAX
    package's bench excludes it), plus one profile of the kernel run.
    ``baseline``: an earlier build of B2 to time turn by turn, or None."""
    import torch

    from dart_planner_tpu_torch.ops import cuda_rollout
    from dart_planner_tpu_torch.sim import WorldConfig, closed_loop, physics, worlds

    base = mc_config()
    S, (spp, spv, spa), gw, obs = random_tick_inputs(base.control, B_MC, 40, 20, dev)
    args = (base.control, base.physics, base.control_dt, 40, 1, S, spp, spv, spa, gw, obs)
    t_k = cuda_time_ms(lambda: cuda_rollout.run_tick_block(*args))
    d_k = kernel_device_ms(lambda: cuda_rollout.run_tick_block(*args), "tick_block_kernel")
    t_p = cuda_time_ms(lambda: cuda_rollout.run_tick_block_plain(*args), reps=5)
    bnd, bound_by = b2_bound(B_MC, 40, 1, *args[5:], *cuda_rollout.run_tick_block(*args))
    mhz = sm_clock_mhz(lambda: cuda_rollout.run_tick_block(*args))
    floor = b2_floor_ms(40, 1, mhz)
    print(f"[10 times] ({card}) tick block B={B_MC} T=40 median CUDA-event ms: "
          f"kernel {t_k:.4f} (the kernel alone {d_k:.4f} by torch.profiler), plain "
          f"{t_p:.4f}, bound {bnd:.3g} ({bound_by}; share of the kernel alone "
          f"{bnd / d_k:.3g}), latency floor {floor:.4f} ({B2_CHAIN_CYCLES} cycles a "
          f"tick reckoned from assumed instruction latencies, not read) at the SM clock "
          f"of {mhz:.0f} MHz under load (share of the kernel alone {floor / d_k:.3g})",
          flush=True)
    if baseline is not None:
        print(f"[10 baseline] ({card}) tick block B={B_MC} T=40: "
              f"{tick_block_turns(args, baseline)}", flush=True)

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
    return {"ms": t_k, "device_ms": d_k, "plain_ms": t_p, "bound_ms": bnd,
            "bound_by": bound_by, "sm_mhz": mhz}


def _take(states, n: int):
    return states.replace(**{
        f: getattr(states, f)[:n]
        for f in ("timestamp", "position", "velocity", "attitude", "angular_velocity")
    })


def solver_phases(dev, card: str, first) -> dict:
    """Phases 3a-7: kernel B1 against its plain loop at the solve bench's
    shapes, the two-phase solve (the first slice's main path) with the
    launch count set to 0 just before and read just after, the planner
    facade, the fast path, and B1's times at the main paths' shapes
    (``first``: the closed loop's first-replan solve)."""
    import math

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
            tag = f"one round {label} {stage}"
            e = b1_one_round(cfg_r, pr, u0, gvec)
            print(f"[3b {tag}] B={B_BENCH} CG-2, active scenarios {act}: "
                  f"{round_summary(e)}", flush=True)
            check_round(tag, e)
            err_rounds.append(e["du"])

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
    check(conv >= 0.957, f"main path: converged fraction {conv:.4f} < 0.957")
    traj = se3_mpc.extract_trajectory(base, res, 0.0)
    check(bool(torch.isfinite(traj.attitudes).all()
               and torch.isfinite(traj.body_rates).all()),
          "extract_trajectory: non-finite attitudes or rates")
    print(f"[4 main path] solve(method='auto') B={B_BENCH}: {launches} launches, "
          f"converged {conv:.4f}, mean cost {float(res.cost.mean()):.6g}",
          flush=True)
    # solution quality against a ground truth: the lower cost of a
    # 60-round CG-25 solve by the kernel and by the plain loop (the
    # measure of docs/quality.md). The shipping default's max excess is
    # reported; with the perturbed restart (restart_iterations=20) it is
    # held below 0.1.
    cfg_gt = cfg_p1._replace(max_iterations=60, cg_iterations=25)
    u_qp = se3_mpc.initialize_thrusts(base, prob)
    gt = torch.minimum(
        cuda_mpc.solve_thrusts_fused(cfg_gt, prob, u_qp)[4],
        cuda_mpc.solve_thrusts_plain(cfg_gt, prob, u_qp)[4],
    )
    excess = ((res.cost - gt) / gt.abs()).float()
    conv_excess = excess[res.converged]
    res_r = se3_mpc.solve(base._replace(restart_iterations=20), prob, method="auto")
    excess_r = float(((res_r.cost - gt) / gt.abs()).max())
    conv_r = float(res_r.converged.float().mean())
    check(excess_r < 0.1, f"restart_iterations=20: max excess {excess_r:.3g} >= 0.1")
    print(f"[4 quality] excess over a 60-round CG-25 ground truth: p95 "
          f"{float(excess.quantile(0.95)):.3g} max {float(excess.max()):.3g}; "
          f"converged cohort p95 {float(conv_excess.quantile(0.95)):.3g}; "
          f"restart_iterations=20: converged {conv_r:.4f}, max excess {excess_r:.3g} "
          "(< 0.1)", flush=True)

    # -- 5. planner facade ---------------------------------------------------
    # the factory's planner with no device given: on the card by default
    planner = PlannerFactory.create("se3_mpc")
    check(isinstance(planner, se3_mpc.SE3MPCPlanner),
          "PlannerFactory('se3_mpc') is not the port's planner")
    check(planner.device.type == "cuda",
          f"PlannerFactory('se3_mpc') plans on {planner.device}, not the card")
    planner.add_obstacle(center=(2.5, 0.0, 2.0), radius=0.5)
    start, goal = (0.0, 0.0, 2.0), (5.0, 0.0, 3.0)
    state = DroneState.create(timestamp=0.0, position=start)
    check(state.position.device.type == "cuda", "DroneState.create is not on the card")
    for i in range(5):
        before = cuda_mpc.LAUNCHES
        traj = planner.plan_trajectory(state, goal)
        check(cuda_mpc.LAUNCHES > before, f"replan {i} did not launch the kernel")
    final = traj.positions[-1].cpu().numpy()
    check(bool(np.isfinite(traj.positions.cpu().numpy()).all()), "planner: non-finite plan")
    d_end = float(np.linalg.norm(final - np.asarray(goal)))
    d_start = float(np.linalg.norm(np.asarray(start) - np.asarray(goal)))
    check(d_end < d_start, f"planner: end {d_end:.3f} m from goal, start {d_start:.3f}")
    print(f"[5 planner] PlannerFactory.create('se3_mpc') on {planner.device}: "
          f"5 warm-started replans, each launching B1; last plan ends "
          f"{d_end:.3f} m from the goal (start {d_start:.3f} m)", flush=True)

    # -- 6. fast path ----------------------------------------------------------
    fp = PlannerFastPath()
    check(fp.device.type == "cuda", f"PlannerFastPath() is on {fp.device}, not the card")
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

    # -- 7. times: kernel vs plain
    one = bench_problem(se3_mpc, base, 1, 1, dev)
    u1 = se3_mpc.initialize_thrusts(cfg_p1, one)
    cfg_k, prob_k, u_k = first
    cfg_t = base._replace(  # the tail pass of solve(), as _tail_refine sets it
        max_iterations=base.tail_iterations, cg_iterations=base.tail_cg_iterations,
        gn_warmup_iterations=0, line_search_alphas=base.tail_line_search_alphas,
    )
    n_tail = math.ceil(base.tail_capacity * B_BENCH)
    bound_p1 = b1_bound(cfg_p1, prob)
    bound_tail = b1_bound(cfg_t, prob)[0] * n_tail / B_BENCH
    fused, plain = cuda_mpc.solve_thrusts_fused, cuda_mpc.solve_thrusts_plain
    shapes = (
        ("phase1_4096", f"phase-1 solve B={B_BENCH}", lambda: fused(cfg_p1, prob, u0),
         lambda: plain(cfg_p1, prob, u0), 5, bound_p1),
        ("phase1_1", "phase-1 solve B=1", lambda: fused(cfg_p1, one, u1),
         lambda: plain(cfg_p1, one, u1), 5, b1_bound(cfg_p1, one)),
        ("k11_2048", f"K=11 B={prob_k.p0.shape[0]} (closed loop's first replan)",
         lambda: fused(cfg_k, prob_k, u_k), lambda: plain(cfg_k, prob_k, u_k), 3,
         b1_bound(cfg_k, prob_k)),
        ("solve_4096", f"two-phase solve() B={B_BENCH}",
         lambda: se3_mpc.solve(base, prob, u0, method="cuda"),
         lambda: se3_mpc.solve(base, prob, u0, method="torch"), 3,
         (bound_p1[0] + bound_tail, bound_p1[1])),
    )
    times = {}
    for key, label, run_k, run_p, reps_p, (bnd, bound_by) in shapes:
        t_k = cuda_time_ms(run_k)
        d_k = kernel_device_ms(run_k, "mpc_solve_kernel")
        t_p = cuda_time_ms(run_p, reps=reps_p)
        times[key] = {"ms": t_k, "device_ms": d_k, "plain_ms": t_p, "bound_ms": bnd,
                      "bound_by": bound_by}
        print(f"[7 times] ({card}) {label}, median CUDA-event ms: kernel {t_k:.4f} "
              f"(the kernel alone {d_k:.4f} by torch.profiler), plain {t_p:.4f}, bound "
              f"{bnd:.3g} ({bound_by}; share of the kernel alone {bnd / d_k:.3g})",
              flush=True)

    return {"launches": launches, "max_abs_err": max([err_u] + err_rounds),
            **times["phase1_4096"], "times": times, "converged": conv}


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def fleet_bytes_estimate(config, B: int) -> float:
    """Bytes the fleet solve holds at its peak, reckoned. The peak is phase
    1's gradient in ``se3_mpc._finalize`` (the tail, on a quarter of the
    scenarios, comes after its temporaries are freed). Live then: the
    problem (p0, v0, goal, the padded spheres and mask), the cold start,
    the wrapper's per-step goal copy, the kernel's outputs (thrusts,
    positions, velocities, cost, improvement), and the gradient's own at
    its sphere term ``(coef * diff).sum``: five (N, 3) float32 tensors (the
    rollout's three, the position error and the gradient) and nine (N, K)
    ones (the differences and their product with the coefficients, three
    each; the distances, the hinge values and the coefficients)."""
    N, K = config.prediction_horizon, config.max_obstacles
    problem = 4 * (9 + 4 * K) + K
    outputs = 4 * (3 * 3 * N + 2)
    gradient = 4 * (5 * 3 * N + 9 * N * K)
    return B * (problem + 2 * 4 * 3 * N + outputs + gradient)


def fleet_phase(dev, card: str) -> dict:
    """Phase 11: the fleet (BASELINE config 5) of B_FLEET bench scenarios
    through ``parallel.solve_fleet`` on ``make_fleet_mesh()`` with the
    shipping two-phase config, its stats all-reduced through an NCCL group
    of world size 1 (destroyed at the end). The launch count is set to 0
    just before the counted call and read just after. Then kernel B1 is held
    against its plain version on this fleet's inputs: one Newton round in
    every scenario at phase 1's shape and config and at the tail's, and the
    whole fleet through the plain path."""
    import math

    import torch

    from dart_planner_tpu_torch.common import frames
    from dart_planner_tpu_torch.ops import costs, cuda_mpc
    from dart_planner_tpu_torch.parallel import distributed, scenario
    from dart_planner_tpu_torch.planning import se3_mpc

    config = se3_mpc.SE3MPCConfig()
    prob = bench_problem(se3_mpc, config, B_FLEET, 0, dev)
    gvec = frames.gravity_vector(frames.WorldFrame.ENU, config.gravity, device=dev)
    cost0 = float(costs.condensed_cost(se3_mpc.initialize_thrusts(config, prob), prob,
                                       config.weights, config.dt, config.mass, gvec).mean())
    distributed.initialize(f"localhost:{_free_port()}", 1, 0, backend="nccl")
    try:
        check(torch.distributed.get_backend() == "nccl", "fleet: the group is not NCCL")
        mesh = scenario.make_fleet_mesh()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_mpc.LAUNCHES = 0
        res, st = scenario.solve_fleet(config, mesh, prob)
        torch.cuda.synchronize()
        launches = cuda_mpc.LAUNCHES
        peak = torch.cuda.max_memory_allocated()
        check(st.total.device.type == "cuda", f"fleet: stats on {st.total.device}")
        stats = {name: float(getattr(st, name)) for name in st._fields}

        def solve(with_stats=True):
            return scenario.solve_fleet(config, mesh, prob, with_stats=with_stats)

        t_stats = cuda_time_ms(solve, reps=3, warmup=1)
        t_free = cuda_time_ms(lambda: solve(False), reps=3, warmup=1)
        d_k = kernel_device_ms(solve, "mpc_solve_kernel", reps=2)
        # the plain path on the same fleet, its stats through the same group
        t0 = time.perf_counter()
        res_p, st_p = scenario.solve_fleet(config, mesh, prob, method="torch")
        torch.cuda.synchronize()
        t_plain = 1e3 * (time.perf_counter() - t0)
    finally:
        distributed.shutdown()
    check(launches == 2, f"fleet: B1 launched {launches} times, not 2")
    host = scenario.fleet_statistics(res)
    check(stats["total"] == host["total"] == B_FLEET,
          f"fleet: total {stats['total']} / {host['total']}, not {B_FLEET}")
    check(stats["converged"] == host["converged"],
          f"fleet: converged {stats['converged']} all-reduced, {host['converged']} on the host")
    rel = abs(stats["mean_cost"] - host["mean_cost"]) / abs(host["mean_cost"])
    check(rel <= 1e-6, f"fleet: mean cost all-reduced vs host rel {rel:.3g} > 1e-6")
    check(stats["max_grad_norm"] == host["max_grad_norm"],
          f"fleet: max grad norm {stats['max_grad_norm']} vs {host['max_grad_norm']}")
    for name, x in zip(res.shards[0]._fields, res.shards[0]):
        if x is not None and x.dtype.is_floating_point:
            check(bool(torch.isfinite(x).all()), f"fleet: non-finite {name}")
    conv = host["converged"] / B_FLEET
    check(conv >= 0.957, f"fleet: converged fraction {conv:.4f} < 0.957")
    check(host["mean_cost"] < 0.9 * cost0,
          f"fleet: mean cost {host['mean_cost']:.6g} not below 0.9 x cold start {cost0:.6g}")
    cfg_t = config._replace(  # the tail pass, as _tail_refine sets it
        max_iterations=config.tail_iterations, cg_iterations=config.tail_cg_iterations,
        newton_full_curvature=True, gn_warmup_iterations=0, tail_iterations=0,
        restart_iterations=0, line_search_alphas=config.tail_line_search_alphas,
    )
    # the kernel against its plain version on this fleet's inputs
    kern = res.gather(dev)
    own = costs.condensed_cost(kern.thrusts, prob, config.weights, config.dt, config.mass,
                               gvec)
    c_own = float(((kern.cost - own).abs() / own.abs()).max())
    check(c_own <= 1e-5, f"fleet: cost vs own thrusts rel {c_own:.3g} > 1e-5")
    n_tail = math.ceil(config.tail_capacity * B_FLEET)
    rounds = {}
    for label, cfg_r, pr in (
        ("phase 1", config._replace(tail_iterations=0), prob),
        ("tail", cfg_t, costs.Problem(*[None if x is None else x[:n_tail] for x in prob])),
    ):
        rounds[label] = b1_one_round(cfg_r._replace(max_iterations=1, cg_iterations=2), pr,
                                     se3_mpc.initialize_thrusts(config, pr), gvec)
    plain = scenario.fleet_statistics(res_p)
    conv_p = plain["converged"] / B_FLEET
    rel_p = abs(host["mean_cost"] - plain["mean_cost"]) / plain["mean_cost"]
    c_p = res_p.gather(dev).cost
    rel_s = (kern.cost - c_p).abs() / c_p.abs()
    agree = float((rel_s <= 1e-5).float().mean())
    print(f"[11 fleet vs plain] one Newton round at CG-2 from the cold start, every scenario: "
          f"phase 1 at B={B_FLEET}: {round_summary(rounds['phase 1'])}; the tail's config at "
          f"B={n_tail}: {round_summary(rounds['tail'])}. Two-phase kernel fleet: cost vs own "
          f"thrusts rel {c_own:.3g} (1e-5); the plain path on the same fleet "
          f"({t_plain:.1f} ms, host clock): converged {conv_p:.4f} (kernel {conv:.4f}, "
          f"apart {abs(conv - conv_p):.4f}, <= 0.002), mean cost {plain['mean_cost']:.6g} "
          f"(kernel rel {rel_p:.3g}, <= 1e-3), NCCL total {float(st_p.total):.0f}; "
          f"per-scenario cost within 1e-5 rel on {agree:.4f} of the fleet, p99 rel "
          f"{float(rel_s.quantile(0.99)):.3g}, max {float(rel_s.max()):.3g} (near-ties "
          "part the paths at the full budget, ROADMAP C.9: not gated)", flush=True)
    for label, e in rounds.items():
        check_round(f"fleet one round {label}", e, outliers=FLEET_ROUND_OUTLIERS)
    check(float(st_p.total) == B_FLEET, f"fleet plain: total {float(st_p.total)}")
    check(abs(conv - conv_p) <= 0.002,
          f"fleet: converged {conv:.4f} vs the plain path's {conv_p:.4f} beyond 0.002")
    check(rel_p <= 1e-3, f"fleet: mean cost vs the plain path's rel {rel_p:.3g} > 1e-3")
    p1 = b1_bound(config._replace(tail_iterations=0), prob)
    bnd = (p1[0] + b1_bound(cfg_t, prob)[0] * config.tail_capacity, p1[1])
    est = fleet_bytes_estimate(config, B_FLEET)
    print(f"[11 fleet] ({card}) solve_fleet B={B_FLEET} on make_fleet_mesh() "
          f"{mesh.shape}, two-phase, stats all-reduced over NCCL (world 1): B1 launches "
          f"{launches}; converged {conv:.4f} (>= 0.957), mean cost {host['mean_cost']:.6g} "
          f"(cold start {cost0:.6g}); all-reduced = host stats (mean cost rel {rel:.3g}); "
          f"{B_FLEET / (t_stats / 1e3):.1f} solves/s ({t_stats:.3f} ms a call, median of 3 "
          f"by CUDA events; with_stats=False {t_free:.3f} ms); B1 alone {d_k:.3f} ms a call "
          f"by torch.profiler (bound {bnd[0]:.3g} ms, {bnd[1]}); peak memory "
          f"{peak / 1e9:.3f} GB (reckoned {est / 1e9:.3f} GB)", flush=True)
    return {"launches": launches, "ms": t_stats, "ms_without_stats": t_free,
            "device_ms": d_k, "bound_ms": bnd[0], "bound_by": bnd[1],
            "peak_bytes": peak, "converged": conv, "stats": stats,
            "max_abs_err": max(e["du"] for e in rounds.values())}


def figure8_kernel_checks(dev) -> float:
    """Phase 12, first: both kernels against their plain versions on
    figure-8's first replan, built as ``figure8_tracking`` builds it. B1 at
    B=1 with per-step (1, N, 3) goals, no obstacles and the shifted hover
    warm start, at the full default budget: the cost to 1e-5 relative and
    the positions and velocities to 2e-3 (phase 3's limits; the thrusts
    may part at a near-tie, ROADMAP C.9, and are not gated). Then B2 at
    B=1, T=8, K=0 on the setpoints figure-8 makes from the kernel's plan
    (accelerations ``u / mass + g``), at phase 8's tolerance. Returns the
    largest |kernel - plain| of the gated B2 rows."""
    import math

    import torch

    from dart_planner_tpu_torch import DroneState
    from dart_planner_tpu_torch.common import frames
    from dart_planner_tpu_torch.control import geometric
    from dart_planner_tpu_torch.ops import costs, cuda_mpc, cuda_rollout
    from dart_planner_tpu_torch.planning import se3_mpc
    from dart_planner_tpu_torch.sim import physics, scenarios

    mpc, ctl = se3_mpc.SE3MPCConfig(), geometric.GeometricConfig(mass=1.5, max_thrust=25.0)
    phys_cfg = physics.PhysicsConfig(max_thrust=25.0)
    N, T, control_dt = mpc.prediction_horizon, 8, 0.0025
    omega = 2 * math.pi / 12.0
    t = torch.zeros((1,), device=dev)
    p0, v0, _ = scenarios._fig8_ref(t, 4.0, 2.0, omega, 3.0)
    offsets = mpc.dt * (1.0 + torch.arange(N, device=dev))
    goals, _, _ = scenarios._fig8_ref(t[:, None] + offsets, 4.0, 2.0, omega, 3.0)
    prob = costs.Problem(p0=p0, v0=v0, goal=goals, obstacles=torch.zeros((1, 1, 4), device=dev),
                         obstacle_mask=torch.zeros((1, 1), dtype=torch.bool, device=dev))
    hover = torch.tensor([0.0, 0.0, mpc.hover_thrust], device=dev).expand(1, N, 3)
    u_start = se3_mpc.shift_warm_start(mpc, hover)
    ku, _, kpos, kvel, kcost = cuda_mpc.solve_thrusts_fused(mpc, prob, u_start,
                                                            use_obstacles=False)
    pu, _, ppos, pvel, pcost = cuda_mpc.solve_thrusts_plain(mpc, prob, u_start,
                                                            use_obstacles=False)
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(x).all()) for x in (ku, kpos, kvel, kcost)),
          "figure-8 B1: non-finite kernel output")
    c_rel = float(((kcost - pcost).abs() / pcost.abs()).max())
    du, dp, dv = (float((k - p).abs().max()) for k, p in ((ku, pu), (kpos, ppos),
                                                           (kvel, pvel)))
    print(f"[12 figure-8 B1] B=1, per-step (1, {N}, 3) goals, no obstacles, shifted "
          f"hover warm start, full budget: cost rel {c_rel:.3g} (rtol 1e-5); max |dpos| "
          f"{dp:.3g} |dvel| {dv:.3g} (atol 2e-3); max |du| {du:.3g} (not gated)",
          flush=True)
    check(c_rel <= 1e-5, f"figure-8 B1: cost rel {c_rel:.3g} > 1e-5")
    check(dp <= 2e-3, f"figure-8 B1: position max |kernel - plain| {dp:.3g} > 2e-3")
    check(dv <= 2e-3, f"figure-8 B1: velocity max |kernel - plain| {dv:.3g} > 2e-3")

    gvec = frames.gravity_vector(frames.WorldFrame.ENU, mpc.gravity, device=dev)
    rb = physics.RigidBodyState.from_drone_state(
        DroneState.zeros((1,), device=dev).replace(position=p0, velocity=v0))
    S = cuda_rollout.pack_state(rb, geometric.ControllerState.zeros(ctl, (1,), device=dev))
    sp = cuda_rollout.setpoints_from_plan(kpos, kvel, ku / mpc.mass + gvec, T, control_dt,
                                          mpc.dt)
    args = (ctl, phys_cfg, control_dt, T, 1, S, *sp,
            torch.zeros((cuda_rollout.ACC_ROWS, 1), device=dev), None)
    ks, ka = cuda_rollout.run_tick_block(*args)
    ps, pa = cuda_rollout.run_tick_block_plain(*args)
    torch.cuda.synchronize()
    errs = [float((k - p).abs().max()) for k, p in ((ks, ps), (ka[:3], pa[:3]))]
    for name, k, p in (("state", ks, ps), ("accumulator", ka[:3], pa[:3])):
        check(bool(torch.isfinite(k).all()), f"figure-8 B2: non-finite {name} rows")
        check(bool(((k - p).abs() <= 1e-4 + 1e-4 * p.abs()).all()),
              f"figure-8 B2: {name} rows beyond atol 1e-4 + rtol 1e-4")
    check(bool(ka[3, 0] == 1e30), "figure-8 B2: a clearance without spheres")
    print(f"[12 figure-8 B2] B=1 T={T} K=0 on the setpoints of the kernel's first plan: max "
          f"|kernel - plain| state {errs[0]:.3g}, accumulators {errs[1]:.3g} (atol 1e-4 + "
          "rtol 1e-4)", flush=True)
    return max(errs)


def scenarios_phase(dev, card: str) -> dict:
    """Phase 12: BASELINE configs 1-3 on the card (the default device),
    each with the launch counts set to 0 just before and read just after."""
    import numpy as np
    import torch

    from dart_planner_tpu_torch.ops import cuda_mpc, cuda_rollout
    from dart_planner_tpu_torch.sim import scenarios

    err_b2 = figure8_kernel_checks(dev)
    counts = {}

    def counted(name, fn):
        torch.cuda.synchronize()
        cuda_mpc.LAUNCHES = cuda_rollout.LAUNCHES = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        counts[name] = {"B1": cuda_mpc.LAUNCHES, "B2": cuda_rollout.LAUNCHES}
        return out, time.perf_counter() - t0

    hover, _ = counted("hover", scenarios.hover_to_waypoint)
    check(hover.positions.device.type == "cuda", "hover: not on the card")
    d_hover = float(np.linalg.norm(hover.positions[-1].cpu().numpy() - [5.0, 0.0, 3.0]))
    check(d_hover < 0.5, f"hover: last position {d_hover:.3f} m from the goal (>= 0.5)")
    (nav, mapper), _ = counted("mapper", scenarios.mapper_navigation)
    nav_pos = nav.positions.cpu().numpy()
    check(bool(np.isfinite(nav_pos).all()), "mapper navigation: non-finite plan")
    check(mapper.is_trajectory_safe(nav_pos, safety_margin=0.2, threshold=0.8),
          "mapper navigation: the plan is not safe in the map")
    for name in ("hover", "mapper"):
        check(counts[name] == {"B1": 1, "B2": 0},
              f"{name}: launches {counts[name]}, not one of B1")

    fig, wall = counted("figure8", scenarios.figure8_tracking)
    rmse, max_err = float(fig.tracking_rmse), float(fig.max_error)
    check(counts["figure8"] == {"B1": 600, "B2": 600},
          f"figure-8: launches {counts['figure8']}, not 600 of each")
    check(bool(torch.isfinite(fig.positions).all()), "figure-8: non-finite positions")
    check(rmse < 0.5, f"figure-8: tracking RMSE {rmse:.4f} m >= 0.5")
    rel = abs(rmse - JAX_FIG8_RMSE) / JAX_FIG8_RMSE
    check(rel <= 0.10, f"figure-8: RMSE {rmse:.4f} m is {rel:.1%} from JAX's {JAX_FIG8_RMSE:.4f}")
    check(max_err < 1.0, f"figure-8: max error {max_err:.4f} m >= 1.0")
    _, wall2 = counted("figure8_again", scenarios.figure8_tracking)
    # the first replans through both kernels against the plain path (B1's
    # per-step-goal branch with the shifted warm start, and B2, replan by
    # replan): positions to 1e-3 m, RMSE to 1% relative
    prefix = 20
    pre_k, t_kernels = counted("prefix_kernels", lambda: scenarios.figure8_tracking(
        num_replans=prefix))
    pre_p, t_plain = counted("prefix_plain", lambda: scenarios.figure8_tracking(
        num_replans=prefix, method="torch"))
    check(counts["prefix_kernels"] == {"B1": prefix, "B2": prefix}
          and counts["prefix_plain"] == {"B1": 0, "B2": 0},
          f"figure-8 prefix: launches {counts['prefix_kernels']} and "
          f"{counts['prefix_plain']}, not {prefix} of each and none")
    dpos = float((pre_k.positions - pre_p.positions).abs().max())
    rmse_k, rmse_p = float(pre_k.tracking_rmse), float(pre_p.tracking_rmse)
    rel_pre = abs(rmse_k - rmse_p) / rmse_p
    check(dpos <= 1e-3, f"figure-8 prefix: positions max |kernels - plain| {dpos:.3g} > 1e-3")
    check(rel_pre <= 1e-2, f"figure-8 prefix: RMSE {rmse_k:.6f} vs plain {rmse_p:.6f}, "
          f"rel {rel_pre:.3g} > 1e-2")
    print(f"[12 scenarios] ({card}) hover_to_waypoint: {counts['hover']}, last position "
          f"{d_hover:.4f} m from the goal (< 0.5); mapper_navigation: {counts['mapper']}, "
          f"safe in the map; figure8_tracking() N=20, 600 replans of 8 ticks: launches "
          f"{counts['figure8']}, tracking RMSE {rmse:.4f} m (JAX {JAX_FIG8_RMSE:.4f}, "
          f"{rel:.2%} apart, <= 10%), max error {max_err:.4f} m (JAX "
          f"{JAX_FIG8_MAX_ERROR:.4f}); wall {wall:.3f} s the first run, {wall2:.3f} s the "
          f"second (host clock); first {prefix} replans: kernels {t_kernels:.3f} s, plain "
          f"path {t_plain:.3f} s, positions max |kernels - plain| {dpos:.3g} m (1e-3), "
          f"RMSE {rmse_k:.6f} vs {rmse_p:.6f} m (rel {rel_pre:.3g}, 1e-2)", flush=True)
    return {"launches": counts, "rmse": rmse, "max_error": max_err, "wall_s": wall2,
            "err_b2": err_b2, "dpos_prefix": dpos}


def sweep_phase(dev, card: str) -> dict:
    """Phase 13: the resumable sweep around the Monte-Carlo (``run_sweep``
    with ``mc_config()`` from MC_START toward MC_GOAL, no obstacles):
    SWEEP_EPISODES in chunks of SWEEP_CHUNK, stopped after the first chunk
    and resumed from the file under build/; each invocation with the launch
    counts set to 0 just before and read just after. An uninterrupted sweep
    must give the same totals bit for bit."""
    import torch

    from dart_planner_tpu_torch.ops import _build, cuda_mpc, cuda_rollout
    from dart_planner_tpu_torch.sim import checkpoint

    root = _build.BUILD_DIR.parent / "sweep"
    paths = [root / "resumed.npz", root / "whole.npz"]
    for path in paths:
        path.unlink(missing_ok=True)
    cfg = mc_config()
    kw = dict(total_scenarios=SWEEP_EPISODES, chunk=SWEEP_CHUNK, start_center=MC_START,
              goal_center=MC_GOAL)
    runs = []
    for label, path, max_chunks in (("first chunk", paths[0], 1), ("resumed", paths[0], None),
                                    ("uninterrupted", paths[1], None)):
        torch.cuda.synchronize()
        cuda_mpc.LAUNCHES = cuda_rollout.LAUNCHES = 0
        t0 = time.perf_counter()
        ck = checkpoint.run_sweep(cfg, checkpoint_path=path, max_chunks=max_chunks, **kw)
        torch.cuda.synchronize()
        runs.append((label, ck, time.perf_counter() - t0,
                     {"B1": cuda_mpc.LAUNCHES, "B2": cuda_rollout.LAUNCHES}))
    (_, first, t1, l1), (_, resumed, t2, l2), (_, whole, t3, l3) = runs
    per_chunk = {"B1": cfg.num_replans, "B2": cfg.num_replans}
    check(first.scenario_cursor == SWEEP_CHUNK, f"sweep: cursor {first.scenario_cursor} "
          f"after the first chunk")
    check(l1 == per_chunk and l2 == per_chunk,
          f"sweep: launches {l1} and {l2}, not {per_chunk} a chunk")
    check(resumed.scenario_cursor == SWEEP_EPISODES,
          f"sweep: cursor {resumed.scenario_cursor} after resuming")
    check(resumed.success_rate >= 0.97, f"sweep: success {resumed.success_rate:.4f} < 0.97")
    same = ((resumed.successes, resumed.crashes, resumed.sum_final_distance)
            == (whole.successes, whole.crashes, whole.sum_final_distance))
    check(same, f"sweep: resumed ({resumed.successes}, {resumed.crashes}, "
          f"{resumed.sum_final_distance!r}) != uninterrupted ({whole.successes}, "
          f"{whole.crashes}, {whole.sum_final_distance!r})")
    print(f"[13 sweep] ({card}) run_sweep {SWEEP_EPISODES} episodes in chunks of "
          f"{SWEEP_CHUNK}: first chunk {l1} in {t1:.3f} s (the first call's warm-up "
          f"included), resumed from {paths[0].name} {l2} in {t2:.3f} s "
          f"({SWEEP_CHUNK / t2:.1f} episodes/s); success {resumed.success_rate:.4f}, "
          f"crashes {resumed.crashes}, mean final distance "
          f"{resumed.sum_final_distance / SWEEP_EPISODES:.4f} m; uninterrupted sweep "
          f"{l3} in {t3:.3f} s ({SWEEP_EPISODES / t3:.1f} episodes/s), the same totals "
          "bit for bit", flush=True)
    return {"launches": {"B1": l1["B1"] + l2["B1"], "B2": l1["B2"] + l2["B2"]},
            "success": resumed.success_rate, "episodes_per_s": SWEEP_EPISODES / t3}


MISSION_WAYPOINTS = [(3.0, 0.0, 3.0), (3.0, 3.0, 3.0)]  # tests/test_hardware_mission.py
MISSION_PARITY_REPLANS = 10
# the tick window (400 ticks, 1 s of the vehicle's clock at 400 Hz) traced for
# the device's idle share during the mission, after a second of warm flight
MISSION_PROFILE_TICKS = (400, 800)
VEHICLE_FLEET = 2048


def _event_pair():
    import torch

    start = torch.cuda.Event(enable_timing=True)
    start.record()
    return start


def _elapsed(pairs) -> list:
    """ms of each (start, end) event pair, after a synchronize."""
    import torch

    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in pairs]


def _pcts(ms: list) -> str:
    import numpy as np

    return (f"p50 {float(np.percentile(ms, 50)):.3f} p95 {float(np.percentile(ms, 95)):.3f} "
            f"max {max(ms):.3f} ms over {len(ms)}")


class _TimedTicks:
    """Wraps a vehicle's ``step`` with CUDA events around each tick. With a
    ``trace`` window (first, end) of tick indices it instead starts a
    torch.profiler pass (device activity only) at the first and ends the
    mission at the end, so the trace covers that window of a flying
    mission and its processing falls after the mission."""

    def __init__(self, step, runner=None, trace=None):
        self.step, self.runner, self.trace = step, runner, trace
        self.pairs, self.n, self.prof, self.t0, self.t1 = [], 0, None, 0.0, 0.0

    def __call__(self, dt=None):
        import torch
        from torch.profiler import ProfilerActivity, profile

        if self.trace and self.n == self.trace[0]:
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t0 = time.perf_counter()
        start = _event_pair()
        out = self.step(dt)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self.pairs.append((start, end))
        self.n += 1
        if self.trace and self.n == self.trace[1]:
            torch.cuda.synchronize()
            self.t1 = time.perf_counter()
            self.runner.state.active = False  # ends the mission: the window is flown
            self.runner._mission_done.set()
        return out

    def summary(self) -> dict:
        """The traced window's device time (after the mission)."""
        check(self.prof is not None and self.t1 > 0, f"mission: ended after {self.n} "
              f"ticks, before the traced window {self.trace}")
        self.prof.__exit__(None, None, None)
        return profile_summary(self.prof, self.t1 - self.t0)


def _fly(vehicle, runner, ticks) -> tuple:
    """``runner.start_mission`` over MISSION_WAYPOINTS with ``ticks`` as the
    vehicle's step, after one tick outside the mission (the tests' warm-up),
    with the launch counts set to 0 just before and read just after:
    (report, wall seconds, launches)."""
    import asyncio

    import torch

    from dart_planner_tpu_torch.ops import cuda_mpc, cuda_rollout

    vehicle.step = ticks

    async def fly():
        await vehicle.connect()
        await vehicle.arm()
        vehicle.step()
        torch.cuda.synchronize()
        cuda_mpc.LAUNCHES = cuda_rollout.LAUNCHES = 0
        t0 = time.perf_counter()
        report = await runner.start_mission(MISSION_WAYPOINTS)
        torch.cuda.synchronize()
        return report, time.perf_counter() - t0, {"B1": cuda_mpc.LAUNCHES,
                                                  "B2": cuda_rollout.LAUNCHES}

    return asyncio.run(fly())


def mission_phase(dev, card: str) -> dict:
    """Phase 14a: the hardware mission at the deployment's settings. A
    ``MissionRunner`` over ``SimulatedVehicleIO`` on the card at the default
    ``MissionConfig`` (400 Hz control, 50 Hz planning) and the default
    ``SE3MPCConfig`` flies the two waypoints of tests/test_hardware_mission.py,
    with the launch counts set to 0 just before and read just after. Every
    plan is timed by CUDA events around ``plan_trajectory``, every vehicle
    tick likewise, and the first MISSION_PARITY_REPLANS solves are recorded
    (problem, warm start, positions) for phase 14c. A second flight, traced
    by torch.profiler over ticks MISSION_PROFILE_TICKS and ended there,
    gives the device's idle share."""
    import torch

    from dart_planner_tpu_torch import DroneState
    from dart_planner_tpu_torch.hardware.mission import MissionConfig, MissionRunner
    from dart_planner_tpu_torch.hardware.simulated_vehicle import SimulatedVehicleIO
    from dart_planner_tpu_torch.ops import cuda_mpc
    from dart_planner_tpu_torch.planning import se3_mpc

    config = se3_mpc.SE3MPCConfig()
    # the facade's launches a plan, on a planner of its own
    warm = se3_mpc.SE3MPCPlanner(config, device=dev)
    torch.cuda.synchronize()
    before = cuda_mpc.LAUNCHES
    warm.plan_trajectory(DroneState.create(position=(0.0, 0.0, 2.0), device=dev),
                         MISSION_WAYPOINTS[0])
    torch.cuda.synchronize()
    per_plan = cuda_mpc.LAUNCHES - before
    check(per_plan == 2, f"mission: {per_plan} launches of B1 a plan, not 2 (two-phase)")

    def mission():
        vehicle = SimulatedVehicleIO({"initial_position": (0.0, 0.0, 2.0)})
        check(vehicle.device == dev, f"mission: the vehicle is on {vehicle.device}")
        planner = se3_mpc.SE3MPCPlanner(config)  # the card by default
        runner = MissionRunner(vehicle, MissionConfig(), planner=planner)
        check(runner.device == dev, f"mission: the runner is on {runner.device}")
        return vehicle, planner, runner

    per_tick = tick_launches(dev)
    vehicle, planner, runner = mission()
    plan_pairs, records = [], []
    plan = planner.plan_trajectory

    def timed_plan(state, goal):
        start = _event_pair()
        traj = plan(state, goal)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        plan_pairs.append((start, end))
        return traj

    solve = se3_mpc.solve

    def recording_solve(cfg, prob, u_init=None, use_obstacles=True, method="auto"):
        res = solve(cfg, prob, u_init, use_obstacles, method)
        if len(records) < MISSION_PARITY_REPLANS:
            records.append((prob, None if u_init is None else u_init.clone(),
                            use_obstacles, res.positions.clone()))
        return res

    planner.plan_trajectory = timed_plan
    ticks = _TimedTicks(vehicle.step)
    se3_mpc.solve = recording_solve
    try:
        report, wall, launches = _fly(vehicle, runner, ticks)
    finally:
        se3_mpc.solve = solve
    plan_ms = _elapsed(plan_pairs)
    tick_ms = _elapsed(ticks.pairs[1:])  # without the warm-up tick
    ctl = report["scheduler"]["tasks"]["control"]
    plans = len(runner.state.planning_times_ms)
    check(plans == len(plan_ms), f"mission: {len(plan_ms)} calls of plan_trajectory, "
          f"{plans} plans recorded")
    check(report["mission_complete"], f"mission: not complete: {report}")
    check(report["waypoints_reached"] == 2 and report["failsafe_reason"] is None,
          f"mission: {report['waypoints_reached']} waypoints, failsafe "
          f"{report['failsafe_reason']!r}")
    check(report["planning_failures"] == 0,
          f"mission: {report['planning_failures']} planning failures")
    check(planner.emergency_plans == 0,
          f"mission: {planner.emergency_plans} emergency (hover) plans returned")
    check(launches == {"B1": plans * per_plan, "B2": 0},
          f"mission: launches {launches}, not {plans} plans x {per_plan} of B1 and none of B2")
    check(len(records) == MISSION_PARITY_REPLANS, f"mission: {len(records)} replans recorded")

    # the traced flight: the same mission, ended after the traced window
    tvehicle, tplanner, trunner = mission()
    traced = _TimedTicks(tvehicle.step, trunner, MISSION_PROFILE_TICKS)
    _, twall, tlaunches = _fly(tvehicle, trunner, traced)
    prof = traced.summary()
    tplans = len(trunner.state.planning_times_ms)
    check(prof["busy"] > 0, "mission: the traced window holds no device time")
    check(tlaunches == {"B1": tplans * per_plan, "B2": 0},
          f"traced mission: launches {tlaunches}, not {tplans} plans x {per_plan}")
    print(f"[14a mission] ({card}) MissionRunner over SimulatedVehicleIO on {dev}, "
          f"MissionConfig() (control {runner.config.control_frequency:.0f} Hz, planning "
          f"{runner.config.planning_frequency:.0f} Hz), SE3MPCConfig() (N={config.prediction_horizon}"
          f", {config.max_iterations} rounds, two-phase): complete, "
          f"{report['waypoints_reached']} waypoints, {plans} plans, 0 planning failures, "
          f"0 emergency plans, launches {launches} ({per_plan} of B1 a plan); a vehicle "
          f"tick {per_tick['kernels']:.0f} kernel launches and {per_tick['copies']:.0f} "
          f"copies on the card, {per_tick['ops']:.0f} top-level host ops; wall "
          f"{wall:.3f} s for {vehicle.sim_time:.3f} s of the vehicle's clock; plan (CUDA "
          f"events around plan_trajectory) {_pcts(plan_ms)}; vehicle tick (CUDA events around "
          f"step) {_pcts(tick_ms)}; control task: {ctl['execution_count']} ticks at "
          f"{ctl.get('achieved_frequency_hz', 0.0):.1f} Hz achieved, {ctl['overruns']} overruns "
          f"(> {1e3 / runner.config.control_frequency:.2f} ms), {ctl['missed_deadlines']} "
          f"missed deadlines, execution mean {ctl.get('mean_execution_ms', 0.0):.3f} p95 "
          f"{ctl.get('p95_execution_ms', 0.0):.3f} max {ctl.get('max_execution_ms', 0.0):.3f} "
          f"ms (host clock). Traced flight (ended after tick {MISSION_PROFILE_TICKS[1]}, "
          f"{tplans} plans, launches {tlaunches}, {twall:.3f} s): device idle share "
          f"{prof['idle']:.4f} over ticks {MISSION_PROFILE_TICKS} ({prof['busy'] * 1e3:.3f} ms "
          f"busy of {prof['wall'] * 1e3:.3f} ms, torch.profiler, device activity only; top "
          f"{prof['top'][:3]})", flush=True)
    return {"launches": launches["B1"], "plans": plans, "per_plan": per_plan,
            "records": records, "config": config, "plan_ms": plan_ms, "tick_ms": tick_ms,
            "wall_s": wall, "idle": prof["idle"], "control": ctl, "per_tick": per_tick}


def tick_launches(dev, ticks: int = 20) -> dict:
    """What one tick of the simulated vehicle on the card issues, from a
    torch.profiler pass over ``ticks`` ticks of a vehicle flying its
    takeoff plan: device kernels, device copies (memcpy and memset) and
    top-level host ops, each a tick."""
    import asyncio

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dart_planner_tpu_torch.hardware.simulated_vehicle import SimulatedVehicleIO

    vehicle = SimulatedVehicleIO({"initial_position": (0.0, 0.0, 2.0)}, device=dev)

    async def arm():
        await vehicle.connect()
        await vehicle.arm()
        await vehicle.takeoff(3.0)

    asyncio.run(arm())
    for _ in range(5):
        vehicle.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            vehicle.step()
        torch.cuda.synchronize()
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    copies = sum(1 for e in device if "memcpy" in e.name.lower() or "memset" in e.name.lower())
    ops = sum(1 for e in events if e.device_type == DeviceType.CPU and e.cpu_parent is None
              and e.name.startswith("aten::"))
    return {"kernels": (len(device) - copies) / ticks, "copies": copies / ticks,
            "ops": ops / ticks}


class _RatePlant:
    """The rigid plant of tests/test_three_layer_rt.py, flown on thrust and
    body-rate commands, on the host (float64 numpy)."""

    MASS, GRAVITY = 1.5, (0.0, 0.0, -9.81)

    def __init__(self, position):
        import numpy as np

        self.pos = np.asarray(position, float)
        self.vel = np.zeros(3)
        self.att = np.zeros(3)

    def step(self, thrust, rates, dt):
        import numpy as np
        import torch

        from dart_planner_tpu_torch.ops import so3

        self.att = self.att + np.asarray(rates) * dt
        self.att[:2] = np.clip(self.att[:2], -0.6, 0.6)
        R = so3.euler_to_rotmat(torch.tensor(self.att, dtype=torch.float32)).numpy()
        acc = R @ np.array([0.0, 0.0, float(thrust)]) / self.MASS + np.asarray(self.GRAVITY)
        self.vel = self.vel + acc * dt
        self.pos = self.pos + self.vel * dt

    def setpoint(self, acc_des):
        """Attitude and thrust from an acceleration, at yaw 0."""
        import numpy as np

        u = self.MASS * (np.asarray(acc_des, float) - np.asarray(self.GRAVITY))
        pitch = np.arctan2(u[0], max(u[2], 1e-6))
        roll = np.arctan2(-u[1], float(np.hypot(u[0], u[2])))
        return np.array([roll, pitch, 0.0]), float(np.linalg.norm(u))


def three_layer_phase(dev, card: str, per_plan: int) -> dict:
    """Phase 14b: the three-layer loop of tests/test_three_layer_rt.py on the
    card at the default ``SE3MPCConfig``: L1 ``GlobalMissionPlanner`` goals,
    L2 plans (kernel B1) at 10 Hz, the trajectory smoother on the card, the
    real-time control-loop executor (C++ when it builds), a host plant; with
    the launch counts set to 0 just before and read just after."""
    import numpy as np
    import torch

    from dart_planner_tpu_torch import DroneState
    from dart_planner_tpu_torch.control.smoother import TrajectorySmoother
    from dart_planner_tpu_torch.ops import cuda_mpc, cuda_rollout
    from dart_planner_tpu_torch.planning import se3_mpc
    from dart_planner_tpu_torch.planning.global_mission import (
        GlobalMissionPlanner, MissionPhase, SemanticWaypoint)
    from dart_planner_tpu_torch.runtime.rt_executor import RealTimeControlLoop, create_control_loop

    mission = GlobalMissionPlanner()
    mission.set_mission_waypoints([SemanticWaypoint(MISSION_WAYPOINTS[0], "survey_corner"),
                                   SemanticWaypoint(MISSION_WAYPOINTS[1], "goal_pad")])
    planner = se3_mpc.SE3MPCPlanner(se3_mpc.SE3MPCConfig())
    smoother = TrajectorySmoother()
    check(planner.device == dev and smoother.device == dev, "three-layer: not on the card")
    loop = create_control_loop(frequency_hz=200.0, prefer_native=True)
    loop.set_gains([1.5, 1.5, 4.0], [0.0, 0.0, 0.2], [1.0, 1.0, 2.5],
                   [6.0, 6.0, 3.0], [0.0, 0.0, 0.0], [0.5, 0.5, 0.3])
    plant = _RatePlant([0.0, 0.0, 0.5])

    def state(t):
        return DroneState.create(timestamp=t, position=plant.pos, velocity=plant.vel,
                                 attitude=plant.att, device=dev)

    phases, hits, plans = set(), 0, 0
    torch.cuda.synchronize()
    cuda_mpc.LAUNCHES = cuda_rollout.LAUNCHES = 0
    loop.start()
    try:
        t0 = time.perf_counter()
        last_plan, last_tick, goal = -1.0, t0, None
        while time.perf_counter() < t0 + 45.0:
            now = time.perf_counter() - t0
            st = state(now)
            phases.add(mission.current_phase)
            if now - last_plan >= 0.1:  # 10 Hz replans (L1 + L2)
                goal = mission.get_current_goal(st)
                traj = planner.plan_trajectory(st, goal)
                plans += 1
                smoother.update_trajectory(
                    traj.replace(timestamps=traj.timestamps - traj.timestamps[..., :1] + now),
                    now)
                last_plan = now
            pos_d, vel_d, acc_d = (x.cpu().numpy().astype(float)
                                   for x in smoother.get_desired_state(now, st))
            att_d, thrust_ff = plant.setpoint(
                acc_d + 2.5 * (pos_d - plant.pos) + 3.0 * (vel_d - plant.vel))
            loop.set_state(plant.pos, plant.vel, plant.att, np.zeros(3))
            loop.set_setpoint(pos_d, vel_d, att_d, np.zeros(3), thrust_ff=thrust_ff)
            cmd = loop.get_command()
            t_now = time.perf_counter()
            dt, last_tick = min(t_now - last_tick, 0.05), t_now
            if cmd is not None:
                plant.step(cmd["thrust"], [cmd["roll_rate"], cmd["pitch_rate"],
                                           cmd["yaw_rate"]], dt)
            if goal is not None and np.linalg.norm(plant.pos - np.asarray(goal)) < 0.6:
                hits += 1
            if mission.current_phase in (MissionPhase.LANDING, MissionPhase.EMERGENCY):
                break
            time.sleep(0.004)
        wall = time.perf_counter() - t0
    finally:
        loop.stop()
    torch.cuda.synchronize()
    launches = {"B1": cuda_mpc.LAUNCHES, "B2": cuda_rollout.LAUNCHES}
    stats = loop.get_stats()
    pstats = planner.get_planning_stats()
    seen = sorted(p.value for p in phases)
    check({MissionPhase.TAKEOFF, MissionPhase.NAVIGATION} <= phases,
          f"three-layer: phases seen {seen}")
    check(mission.current_phase is MissionPhase.LANDING,
          f"three-layer: ended in {mission.current_phase.value} at {plant.pos}")
    check(hits > 0, f"three-layer: no goal reached; position {plant.pos}")
    check(pstats["success_rate"] > 0.9 and pstats["emergency_plans"] == 0,
          f"three-layer: planner {pstats}")
    check(stats["iteration_count"] > 500
          and stats["missed_deadlines"] <= 0.5 * stats["iteration_count"],
          f"three-layer: RT loop {stats}")
    check(launches == {"B1": plans * per_plan, "B2": 0},
          f"three-layer: launches {launches}, not {plans} plans x {per_plan} of B1")
    kind = "C++" if isinstance(loop, RealTimeControlLoop) else "Python"
    print(f"[14b three-layer] ({card}) GlobalMissionPlanner -> SE3MPCPlanner (SE3MPCConfig(), "
          f"{dev}) -> TrajectorySmoother ({dev}) -> {kind} RT loop at 200 Hz -> plant: phases "
          f"{seen}, {hits} control steps within 0.6 m of a goal, LANDING reached in {wall:.3f} s "
          f"(host clock); {plans} plans, success {pstats['success_rate']:.3f}, mean "
          f"{pstats['mean_planning_time_ms']:.3f} ms (host clock), launches {launches}; RT loop "
          f"{stats['iteration_count']} iterations, {stats['missed_deadlines']} missed deadlines",
          flush=True)
    return {"launches": launches["B1"], "plans": plans, "wall_s": wall}


def vehicle_parity_phase(dev, card: str, mission: dict) -> float:
    """Phase 14c: kernel B1 on the mission's first replans against the plain
    path on the same problems and warm starts (positions to 1e-3 m, as
    phase 12 holds figure-8's replans); the batched smoother (B=2048) and
    the EKF fleet on the card against the same calls on CPU tensors.
    Returns B1's largest position difference."""
    import numpy as np
    import torch

    from dart_planner_tpu_torch import DroneState, Trajectory
    from dart_planner_tpu_torch.control import smoother as sm
    from dart_planner_tpu_torch.estimation import ekf
    from dart_planner_tpu_torch.ops import cuda_mpc
    from dart_planner_tpu_torch.planning import se3_mpc

    config = mission["config"]
    dpos = []
    for prob, u0, use_obstacles, pos_k in mission["records"]:
        before = cuda_mpc.LAUNCHES
        plain = se3_mpc.solve(config, prob, u0, use_obstacles, method="torch")
        check(cuda_mpc.LAUNCHES == before, "14c: the plain path launched B1")
        dpos.append(float((pos_k - plain.positions).abs().max()))
    check(max(dpos) <= 1e-3, f"14c: mission replans, positions max |kernel - plain| "
          f"{max(dpos):.3g} m > 1e-3 ({[f'{d:.2g}' for d in dpos]})")

    B, N = VEHICLE_FLEET, 20
    rng = np.random.default_rng(0)
    t_up = rng.uniform(0.0, 0.5, B).astype(np.float32)
    ts = t_up[:, None] + np.float32(0.1) * np.arange(N, dtype=np.float32)
    p0 = rng.normal(0, 2, (B, 1, 3)).astype(np.float32)
    vel = np.broadcast_to(rng.normal(0, 1.5, (B, 1, 3)), (B, N, 3)).astype(np.float32)
    pos = (p0 + (ts - t_up[:, None])[..., None] * vel).astype(np.float32)
    acc = np.zeros((B, N, 3), np.float32)
    jump = pos + rng.normal(0, 1.0, (B, 1, 3)).astype(np.float32)  # a replan that jumps
    drone = rng.normal(0, 2, (B, 3)).astype(np.float32)
    cfg = sm.SmootherConfig()

    def smoother_run(device):
        def t(x):
            return torch.as_tensor(x, device=device)

        st = sm.SmootherState.zeros(N, (B,), device=device)
        st = sm.update_trajectory(cfg, st, Trajectory(t(ts), t(pos), t(vel), t(acc)), t(t_up))
        d = DroneState.zeros((B,), device=device).replace(position=t(drone))
        outs = []
        for k, dt in enumerate((0.0, 0.0025, 0.0025, 0.01, 0.2, 0.21, 0.6, 3.5)):
            if k == 4:  # the fleet replans with jumps: min-jerk transitions
                st = sm.update_trajectory(cfg, st, Trajectory(t(ts + 0.2), t(jump), t(vel),
                                                              t(acc)), t(t_up + 0.2))
            (p, v, a), st = sm.get_desired_state(cfg, st, t(t_up + 0.5 + dt), d)
            outs += [p, v, a]
        return [x.cpu() for x in outs] + [st.in_transition.cpu()]

    gpu, cpu = smoother_run(dev), smoother_run("cpu")
    check(bool((gpu[-1] == cpu[-1]).all()), "14c: smoother transition flags differ")
    err_sm = max(float((g - c).abs().max()) for g, c in zip(gpu[:-1], cpu[:-1]))
    check(err_sm <= 1e-4, f"14c: smoother B={B} card vs CPU max |diff| {err_sm:.3g} > 1e-4")

    ecfg = ekf.EKFConfig()
    accel = rng.normal(0, 1, (40, B, 3)).astype(np.float32)
    meas = rng.normal(0, 1, (40, B, 3)).astype(np.float32)
    p_init = rng.normal(0, 1, (B, 3)).astype(np.float32)

    def ekf_run(device):
        st = ekf.ekf_init(torch.as_tensor(p_init, device=device))
        for k in range(40):
            st = ekf.ekf_predict(ecfg, st, torch.as_tensor(accel[k], device=device), 0.01)
            z = torch.as_tensor(meas[k], device=device)
            st = (ekf.ekf_update_position if k % 2 else ekf.ekf_update_velocity)(ecfg, st, z)
        return st.x.cpu(), st.P.cpu()

    (xg, Pg), (xc, Pc) = ekf_run(dev), ekf_run("cpu")
    err_x = float((xg - xc).abs().max())
    err_P = float(((Pg - Pc).abs() / (Pc.abs() + 1e-6)).max())
    check(err_x <= 1e-4 and err_P <= 1e-3,
          f"14c: EKF fleet B={B} card vs CPU: x {err_x:.3g} (1e-4), P rel {err_P:.3g} (1e-3)")
    print(f"[14c parity] ({card}) B1 on the mission's first {len(dpos)} replans vs "
          f"method='torch' on the same problems and warm starts: positions max |diff| "
          f"{max(dpos):.3g} m (1e-3); smoother B={B} (8 calls, a jumping replan) card vs CPU "
          f"max |diff| {err_sm:.3g} (1e-4); EKF fleet B={B}, 40 predict/update steps, card vs "
          f"CPU: x {err_x:.3g} (1e-4), P rel {err_P:.3g} (1e-3)", flush=True)
    return max(dpos)


DEPLOY_FIELDS = ("timestamps", "positions", "velocities", "accelerations")
EDGE_FLIGHT_S = 10.0  # the edge's flight, s of wall
EDGE_TRACE_S = 2.0  # the last seconds of that flight, traced for the idle share
CLOUD_START_S = 120.0  # for the cloud's process to answer its first request
CLOUD_MAX_S = 900.0  # the cloud's own duration, if nothing stops it first
CLOUD_PARITY_PLANS = 5
ONBOARD_GOAL, ONBOARD_OBSTACLE = (4.0, 1.0, 3.0), ((3.0, -2.0, 2.5), 0.5)


def _traj_digest(out: dict) -> str:
    """The sha256 (16 hex digits) of a served plan's four arrays as float32
    bytes: equal digests mean equal plans, bit for bit."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for name in DEPLOY_FIELDS:
        h.update(np.ascontiguousarray(out[name], np.float32).tobytes())
    return h.hexdigest()[:16]


def in_process_pair(key: str):
    """A REQ/REP pair without a socket: the port's ``RequestHandler`` as the
    server, and a ``RequestClient`` whose exchange hands the request's signed
    bytes to the handler on the caller's thread and returns the reply's signed
    bytes. Each side signs and verifies with its own ``SecureSerializer``
    under ``key``. Phase 15a links the cloud and the edge through it where
    pyzmq is missing."""
    from dart_planner_tpu_torch.comms import SecureSerializer
    from dart_planner_tpu_torch.comms.zmq_transport import RequestClient, RequestHandler

    server = RequestHandler(SecureSerializer(secret_key=key))

    class InProcessClient(RequestClient):
        def _exchange(self, command, payload):
            return server.handle(payload)

    return server, InProcessClient(SecureSerializer(secret_key=key))


def _instrument_cloud() -> tuple:
    """Instruments the port's cloud for phase 15: CUDA events around each
    ``plan_once`` that plans, the digest of each plan served, and the first
    CLOUD_PARITY_PLANS solves (config, problem, warm start, obstacles flag,
    positions) for 15c. Patches the controller class (so the handlers a new
    controller binds are the recording ones) and ``se3_mpc.solve``; returns
    the record and a function that undoes the patches."""
    import torch

    from dart_planner_tpu_torch.apps import cloud
    from dart_planner_tpu_torch.planning import se3_mpc

    rec = {"pairs": [], "served": [], "solves": [], "controller": None}
    cls = cloud.ThreeLayerCloudController
    plan_once, get, solve = cls.plan_once, cls._handle_get_trajectory, se3_mpc.solve

    def timed_plan_once(self):
        rec["controller"] = self
        if self.last_state is None:
            return plan_once(self)
        start = _event_pair()
        plan_once(self)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        rec["pairs"].append((start, end))

    def recording_get(self, data):
        out = get(self, data)
        if out["available"]:
            rec["served"].append(_traj_digest(out))
        return out

    def recording_solve(cfg, prob, u_init=None, use_obstacles=True, method="auto"):
        res = solve(cfg, prob, u_init, use_obstacles, method)
        if len(rec["solves"]) < CLOUD_PARITY_PLANS:
            rec["solves"].append((cfg, prob, None if u_init is None else u_init.clone(),
                                  use_obstacles, res.positions.clone()))
        return res

    cls.plan_once, cls._handle_get_trajectory = timed_plan_once, recording_get
    se3_mpc.solve = recording_solve

    def restore():
        cls.plan_once, cls._handle_get_trajectory = plan_once, get
        se3_mpc.solve = solve

    return rec, restore


def _cloud_summary(rec: dict, launches: int) -> dict:
    """The instrumented cloud's record once it has stopped: plans, B1
    launches, plan ms by CUDA events, the digests served, and (15c) its
    first plans' B1 solves against the plain path on the same problems and
    warm starts (max |positions difference| a plan, m)."""
    import numpy as np

    from dart_planner_tpu_torch.ops import cuda_mpc
    from dart_planner_tpu_torch.planning import se3_mpc

    ms = _elapsed(rec["pairs"])
    dpos = []
    for cfg, prob, u0, use_obstacles, pos in rec["solves"]:
        plain = se3_mpc.solve(cfg, prob, u0, use_obstacles, method="torch")
        dpos.append(float((pos - plain.positions).abs().max()))
    ctl = rec["controller"]
    return {"plans": ctl.plan_count if ctl else 0, "launches": launches,
            "plain_launches": cuda_mpc.LAUNCHES - launches,
            "plan_ms": [float(np.percentile(ms, q)) for q in (50, 95)] + [max(ms)] if ms else [],
            "served": rec["served"], "parity_m": dpos}


def serve_cloud(port: int) -> None:
    """Phase 15a's cloud in a process of its own, as deployed: the port's
    CLI, ``cli.main(["run", "--mode=cloud", "--port", port, ...])``, which
    loads and validates the frozen config, serves ``/metrics`` on
    ``DART_METRICS_PORT`` and runs ``apps.cloud.main`` (the demo mission,
    ``SE3MPCConfig()``, the card) on ``port``, its secret from
    ``DART_ZMQ_SECRET``; instrumented by :func:`_instrument_cloud`, until
    SIGTERM stops its planning loop. Then prints :func:`_cloud_summary`'s
    record as one JSON line."""
    import signal

    from dart_planner_tpu_torch.apps import cli
    from dart_planner_tpu_torch.ops import cuda_mpc

    rec, restore = _instrument_cloud()

    def stop(signum, frame):
        if rec["controller"] is not None:
            rec["controller"].stop()

    signal.signal(signal.SIGTERM, stop)
    rc = cli.main(["run", "--mode=cloud", "--port", str(port), "--duration", str(CLOUD_MAX_S)])
    restore()
    check(rc == 0, f"cloud: the CLI returned {rc}")
    print(json.dumps(_cloud_summary(rec, cuda_mpc.LAUNCHES)), flush=True)


class _EdgeTicks:
    """Wraps the edge vehicle's ``step`` with CUDA events around each tick,
    and traces the device (torch.profiler, device activity only) from the
    first tick after ``trace_from`` (host clock) to the end of the flight;
    :meth:`summary` processes the trace after the flight."""

    def __init__(self, step):
        self.step, self.pairs, self.prof = step, [], None
        self.trace_from, self.t0, self.enter_ms = float("inf"), 0.0, 0.0

    def __call__(self, dt=None):
        import torch
        from torch.profiler import ProfilerActivity, profile

        if self.prof is None and time.perf_counter() >= self.trace_from:
            torch.cuda.synchronize()
            t = time.perf_counter()
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t0 = time.perf_counter()
            self.enter_ms = (self.t0 - t) * 1e3
        start = _event_pair()
        out = self.step(dt)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self.pairs.append((start, end))
        return out

    def summary(self, t1: float) -> dict:
        """The traced window's device time, the window ending at ``t1``
        (host clock, the flight's end)."""
        check(self.prof is not None, "edge: the flight ended before its traced window")
        self.prof.__exit__(None, None, None)
        return {**profile_summary(self.prof, t1 - self.t0), "enter_ms": self.enter_ms}


def _fly_edge(dev, key: str, port: int, client=None) -> dict:
    """The port's ``EdgeController`` at ``EdgeConfig()`` (200 Hz control,
    10 Hz comms) with the JAX test's generous tier windows, flown from
    (0, 0, 2) for EDGE_FLIGHT_S of wall against the cloud on ``port`` (or
    through ``client``), with the launch counts set to 0 just before and
    read just after: each request's round trip on the host clock, each
    tick by CUDA events, the digest of each plan received, and the last
    EDGE_TRACE_S traced for the device's idle share."""
    import asyncio

    import torch
    from torch.profiler import ProfilerActivity, profile

    from dart_planner_tpu_torch.apps.edge import EdgeConfig, EdgeController
    from dart_planner_tpu_torch.common.errors import CommunicationError
    from dart_planner_tpu_torch.comms import SecureSerializer
    from dart_planner_tpu_torch.ops import cuda_mpc, cuda_rollout

    edge = EdgeController(
        EdgeConfig(cloud_port=port, degraded_after_s=2.0, autonomous_after_s=30.0,
                   emergency_after_s=120.0),
        serializer=SecureSerializer(secret_key=key), client=client)
    check(edge.vehicle.device == dev, f"edge: the vehicle is on {edge.vehicle.device}")
    edge.vehicle.rb = edge.vehicle.rb.replace(
        position=torch.tensor([0.0, 0.0, 2.0], device=dev))
    edge.vehicle.step()  # the tests' warm-up tick, outside the flight
    rt_ms, received, failed = [], [], []
    send = edge.client.send_request

    def timed_request(command, data=None):
        t0 = time.perf_counter()
        try:
            out = send(command, data)
        except CommunicationError as e:
            failed.append(str(e))
            raise
        rt_ms.append((time.perf_counter() - t0) * 1e3)
        if command == "get_trajectory" and out.get("available"):
            received.append(_traj_digest(out))
        return out

    edge.client.send_request = timed_request
    ticks = _EdgeTicks(edge.vehicle.step)
    edge.vehicle.step = ticks
    with profile(activities=[ProfilerActivity.CUDA]):  # the tracer's set-up, off the flight
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize()
    cuda_mpc.LAUNCHES = cuda_rollout.LAUNCHES = 0
    t0 = time.perf_counter()
    ticks.trace_from = t0 + EDGE_FLIGHT_S - EDGE_TRACE_S
    try:
        stats = asyncio.run(edge.run(duration=EDGE_FLIGHT_S))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prof = ticks.summary(t1)
    finally:
        edge.stop()
    wall = t1 - t0
    return {"stats": stats, "wall": wall, "rt_ms": rt_ms, "received": received,
            "failed": failed, "tick_ms": _elapsed(ticks.pairs), "prof": prof,
            "rejected": edge.rejected_trajectories, "sim_time": edge.vehicle.sim_time,
            "launches": {"B1": cuda_mpc.LAUNCHES, "B2": cuda_rollout.LAUNCHES}}


def _scrape_metrics(port: int) -> dict:
    """One GET of ``/metrics`` on ``port``: the status, the content type and
    the exposition's sample lines (neither comments nor blank)."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
        body = r.read().decode()
        out = {"status": r.status, "type": r.headers["Content-Type"]}
    out["samples"] = [ln for ln in body.splitlines() if ln and not ln.startswith("#")]
    return out


def _deploy_over_zmq(dev, key: str) -> tuple:
    """15a with pyzmq: the cloud entered through the CLI in a process of its
    own on the card (:func:`serve_cloud`), waited for until it answers, then
    the edge flown in this process over tcp loopback; the CLI's
    ``/metrics`` scraped once after the flight; the cloud stopped by SIGTERM
    and its record read from its output. Returns (cloud record, edge
    record, transport)."""
    import os
    import signal
    import tempfile

    from dart_planner_tpu_torch.common.errors import CommunicationError
    from dart_planner_tpu_torch.comms import SecureSerializer, ZmqClient

    port, metrics_port = _free_port(), _free_port()

    def tail(f, n=2000) -> str:
        f.seek(0)
        return f.read().decode(errors="replace")[-n:]

    with tempfile.TemporaryFile() as out, tempfile.TemporaryFile() as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke.serve_cloud({port})"],
            cwd=pathlib.Path(__file__).resolve().parent, stdout=out, stderr=err,
            env={**os.environ, "DART_ZMQ_SECRET": key,
                 "DART_METRICS_PORT": str(metrics_port)})
        try:
            probe = ZmqClient(port=port, timeout_ms=1000,
                              serializer=SecureSerializer(secret_key=key))
            t0 = time.perf_counter()
            try:
                while True:
                    check(proc.poll() is None, f"cloud: the process exited "
                          f"({proc.returncode}) before it answered: {tail(err)}")
                    try:
                        probe.send_request("status")
                        break
                    except CommunicationError:
                        check(time.perf_counter() - t0 < CLOUD_START_S,
                              f"cloud: no answer in {CLOUD_START_S:.0f} s: {tail(err)}")
            finally:
                probe.close()
            started = time.perf_counter() - t0
            edge = _fly_edge(dev, key, port)
            check(proc.poll() is None, f"cloud: the process died during the flight "
                  f"({proc.returncode}): {tail(err)}")
            scrape = _scrape_metrics(metrics_port)
            check(scrape["status"] == 200 and scrape["type"].startswith("text/plain"),
                  f"cloud: /metrics answered {scrape['status']} {scrape['type']}")
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        lines = tail(out, 10**7).strip().splitlines()
        check(rc == 0 and lines, f"cloud: exit code {rc}, stderr: {tail(err)}")
    cloud = {**json.loads(lines[-1]), "via_cli": True}
    return cloud, edge, (f"ZMQ REQ/REP over tcp loopback, the cloud entered through the CLI "
                         f"(cli.main run --mode=cloud) in its own process, answering "
                         f"{started:.1f} s after its start, its /metrics scraped once "
                         f"({scrape['status']}, {scrape['type']}, "
                         f"{len(scrape['samples'])} samples)")


def _deploy_in_process(dev, key: str) -> tuple:
    """15a without pyzmq: the cloud (``ThreeLayerCloudController`` on the
    card, the demo mission) plans on a thread of this process and the edge
    flies here, linked by :func:`in_process_pair`. Returns (cloud record,
    edge record, transport)."""
    import asyncio
    import threading

    from dart_planner_tpu_torch.apps.cloud import ThreeLayerCloudController
    from dart_planner_tpu_torch.ops import cuda_mpc

    server, client = in_process_pair(key)
    rec, restore = _instrument_cloud()
    try:
        ctl = ThreeLayerCloudController(server=server)
        ctl.initialize_demo_mission()
        thread = threading.Thread(target=asyncio.run,
                                  args=(ctl.run_planning_loop(CLOUD_MAX_S),), daemon=True)
        thread.start()
        try:
            edge = _fly_edge(dev, key, 0, client=client)
        finally:
            ctl.stop()
            thread.join(timeout=60)
        check(not thread.is_alive(), "cloud: the planning thread did not stop")
        # the edge itself launches no kernel: this process's B1 launches
        # since the flight began are the cloud's
        cloud = _cloud_summary(rec, cuda_mpc.LAUNCHES)
    finally:
        restore()
    edge["launches"] = {"B1": 0, "B2": edge["launches"]["B2"]}
    return {**cloud, "via_cli": False}, edge, "in-process (no pyzmq on this machine)"


def deployment_phase(dev, card: str) -> dict:
    """Phases 15a and 15c: the edge<->cloud deployment on the card at full
    width. The cloud (``SE3MPCConfig()``: N=20, K=8; the 128x128x64 voxel
    map, 360-ray lidar, the JAX demo mission) serves plans at 10 Hz; the
    edge flies them at ``EdgeConfig()``. Over ZMQ with the cloud in a
    process of its own where pyzmq is installed, else in one process
    through :func:`in_process_pair`. 15c: B1 on the cloud's first plans
    against the plain path."""
    import secrets

    import numpy as np

    from dart_planner_tpu_torch.apps.edge import FailsafeTier

    t_phase = time.perf_counter()
    key = secrets.token_urlsafe(16)
    try:
        import zmq  # noqa: F401
    except ImportError:
        cloud, edge, transport = _deploy_in_process(dev, key)
    else:
        cloud, edge, transport = _deploy_over_zmq(dev, key)
    stats, plans = edge["stats"], cloud["plans"]
    ctl = stats["scheduler"]["tasks"]["control"]
    z = float(stats["final_position"][2])
    check(stats["tier"] in (FailsafeTier.NOMINAL.value, FailsafeTier.DEGRADED.value),
          f"edge: ended {stats['tier']}")
    check(stats["ticks"] > 100, f"edge: {stats['ticks']} ticks")
    check(z > 2.3, f"edge: final z {z:.3f} m (the takeoff goal is 5 m)")
    check(edge["rejected"] == 0, f"edge: {edge['rejected']} rejected trajectories")
    check(plans > 0 and cloud["launches"] == 2 * plans,
          f"cloud: {cloud['launches']} launches of B1 for {plans} plans, not 2 a plan")
    check(edge["launches"] == {"B1": 0, "B2": 0}, f"edge: launches {edge['launches']}")
    check(edge["received"] and edge["received"][-1] in cloud["served"],
          f"edge: its last plan ({edge['received'][-1:]}) is none the cloud served")
    check(cloud["plain_launches"] == 0, "15c: the plain path launched B1")
    check(len(cloud["parity_m"]) == CLOUD_PARITY_PLANS,
          f"15c: {len(cloud['parity_m'])} cloud plans recorded")
    worst = max(cloud["parity_m"])
    check(worst <= 1e-3, f"15c: the cloud's plans, positions max |kernel - plain| {worst:.3g} m "
          f"> 1e-3 ({[f'{d:.2g}' for d in cloud['parity_m']]})")
    rt, tick = edge["rt_ms"], edge["tick_ms"]
    print(f"[15a deployment] ({card}) {time.perf_counter() - t_phase:.1f} s (host clock) with "
          f"15c; transport={transport}; cloud ThreeLayerCloudController on "
          f"{dev} (SE3MPCConfig(), the 128x128x64 map, 360-ray lidar, the demo mission): {plans} "
          f"plans, B1 launches {cloud['launches']} (2 a plan), plan (CUDA events around "
          f"plan_once) p50 {cloud['plan_ms'][0]:.3f} p95 {cloud['plan_ms'][1]:.3f} max "
          f"{cloud['plan_ms'][2]:.3f} ms; edge EdgeController (EdgeConfig(): 200 Hz control, "
          f"10 Hz comms) on {dev}, {edge['wall']:.3f} s of wall for {edge['sim_time']:.3f} s of "
          f"the vehicle's clock: tier {stats['tier']}, {stats['ticks']} ticks, final z {z:.3f} m, "
          f"{len(edge['received'])} plans received, 0 rejected, the last equal bit for bit to "
          f"one the cloud served ({edge['received'][-1]}), {len(edge['failed'])} requests failed "
          f"(of {len(rt) + len(edge['failed'])}); round trip (host clock, a request) "
          f"{_pcts(rt)}; edge tick (CUDA events around step) {_pcts(tick)}; control task "
          f"{ctl['execution_count']} ticks at {ctl.get('achieved_frequency_hz', 0.0):.1f} Hz "
          f"achieved of 200, {ctl['overruns']} overruns, {ctl['missed_deadlines']} missed "
          f"deadlines; edge launches {edge['launches']}; device idle share "
          f"{edge['prof']['idle']:.4f} over the flight's end ({edge['prof']['busy'] * 1e3:.3f} "
          f"ms busy of {edge['prof']['wall'] * 1e3:.3f} ms traced from {EDGE_TRACE_S:.0f} s "
          f"before it, the tracer's start taking {edge['prof']['enter_ms']:.1f} ms in a tick; "
          f"torch.profiler, device activity of this process; top "
          f"{edge['prof']['top'][:3]})", flush=True)
    print(f"[15c parity] ({card}) B1 on the cloud's first {len(cloud['parity_m'])} plans vs "
          f"method='torch' on the same problems and warm starts: positions max |diff| "
          f"{worst:.3g} m (1e-3)", flush=True)
    return {"launches": cloud["launches"], "plans": plans, "parity_m": worst,
            "via_cli": cloud["via_cli"],
            "plan_ms": cloud["plan_ms"], "rt_ms": [float(np.percentile(rt, q)) for q in (50, 95)],
            "tick_ms": [float(np.percentile(tick, q)) for q in (50, 95)],
            "control_hz": ctl.get("achieved_frequency_hz", 0.0), "idle": edge["prof"]["idle"],
            "transport": transport}


def record_first_solve(rec: list, limit: int = 1):
    """``se3_mpc.solve`` patched to keep the first ``limit`` solves' (config,
    problem, warm start, obstacles flag, positions) in ``rec``; returns the
    function that undoes the patch."""
    from dart_planner_tpu_torch.planning import se3_mpc

    solve = se3_mpc.solve

    def recording_solve(cfg, prob, u_init=None, use_obstacles=True, method="auto"):
        res = solve(cfg, prob, u_init, use_obstacles, method)
        if len(rec) < limit:
            rec.append((cfg, prob, None if u_init is None else u_init.clone(), use_obstacles,
                        res.positions.clone()))
        return res

    se3_mpc.solve = recording_solve

    def restore():
        se3_mpc.solve = solve

    return restore


def plain_gap(rec: list, tag: str) -> float:
    """The recorded solve against the plain path on the same problem and
    warm start: max |positions difference|, m; the plain path must not
    launch B1."""
    from dart_planner_tpu_torch.ops import cuda_mpc
    from dart_planner_tpu_torch.planning import se3_mpc

    check(len(rec) == 1, f"{tag}: no solve was recorded")
    cfg, prob, u0, use_obstacles, pos = rec[0]
    before = cuda_mpc.LAUNCHES
    plain = se3_mpc.solve(cfg, prob, u0, use_obstacles, method="torch")
    check(cuda_mpc.LAUNCHES == before, f"{tag}: the plain path launched B1")
    return float((pos - plain.positions).abs().max())


def onboard_phase(dev, card: str) -> dict:
    """Phase 15b: the edge's own fallback on the card. The port's
    ``OnboardAutonomousController`` (its default planner, N=10, 6 rounds)
    is handed states along a climb at 20 Hz with a cloud plan and good
    link (NOMINAL), then a weak link and no plan (DEGRADED, the cached
    plan), then none (AUTONOMOUS: replans through B1 every 0.5 s toward a
    goal, a local sphere off the path), with the launch counts set to 0
    just before and read just after; its first replan is held against the
    plain path (1e-3 m, 14c's gate). Then ``minimal_takeoff`` on the card:
    peak > 2.0 m, final < 1.5 m."""
    import asyncio

    import torch

    from dart_planner_tpu_torch import DroneState, Trajectory
    from dart_planner_tpu_torch.apps.autonomous import (
        OnboardAutonomousController, OperationalMode)
    from dart_planner_tpu_torch.apps.minimal_takeoff import minimal_takeoff
    from dart_planner_tpu_torch.ops import cuda_mpc, cuda_rollout

    t_phase = time.perf_counter()
    ctl = OnboardAutonomousController()  # the card by default
    check(ctl.device == dev, f"onboard: the controller is on {ctl.device}")
    ctl.set_goal(ONBOARD_GOAL)
    ctl.add_local_obstacle(*ONBOARD_OBSTACLE)
    n = 10
    ts = 0.1 * torch.arange(n, device=dev)
    cloud_plan = Trajectory(
        timestamps=ts, positions=torch.stack([0.1 * ts, 0 * ts, 2.0 + 0.1 * ts], -1),
        velocities=torch.zeros(n, 3, device=dev), accelerations=torch.zeros(n, 3, device=dev))
    schedule = [(0.95, cloud_plan)] * 10 + [(0.5, None)] * 10 + [(0.0, None)] * 40
    rec, modes = [], []
    torch.cuda.synchronize()
    cuda_mpc.LAUNCHES = cuda_rollout.LAUNCHES = 0
    restore = record_first_solve(rec)
    try:
        t0 = time.perf_counter()
        for k, (quality, plan) in enumerate(schedule):
            t = 0.05 * k
            st = DroneState.create(timestamp=t, position=(0.1 * t, 0.0, 2.0 + 0.1 * t),
                                   velocity=(0.1, 0.0, 0.1), device=dev)
            cmd = ctl.compute_control_command(st, plan, connection_quality=quality)
            check(cmd.thrust.device == dev, f"onboard: a command on {cmd.thrust.device}")
            if not modes or modes[-1] is not ctl.current_mode:
                modes.append(ctl.current_mode)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        restore()
    launches = {"B1": cuda_mpc.LAUNCHES, "B2": cuda_rollout.LAUNCHES}
    replans = ctl.get_system_status()["planner_stats"]["total_plans"]
    expected = [OperationalMode.NOMINAL, OperationalMode.DEGRADED, OperationalMode.AUTONOMOUS]
    check(modes == expected, f"onboard: modes {[m.value for m in modes]}")
    check(replans > 0 and launches["B1"] > 0 and launches["B1"] % replans == 0
          and launches["B2"] == 0,
          f"onboard: launches {launches} for {replans} AUTONOMOUS replans")
    dpos = plain_gap(rec, "15b")
    cfg = rec[0][0]
    check(dpos <= 1e-3, f"15b: the first onboard replan, positions max |kernel - plain| "
          f"{dpos:.3g} m > 1e-3")
    t1 = time.perf_counter()
    takeoff = asyncio.run(minimal_takeoff(altitude=3.0, hover_s=1.0))
    t_takeoff = time.perf_counter() - t1
    check(takeoff["peak_altitude"] > 2.0 and takeoff["final_altitude"] < 1.5,
          f"minimal_takeoff: {takeoff}")
    print(f"[15b onboard] ({card}) {time.perf_counter() - t_phase:.1f} s (host clock); "
          f"OnboardAutonomousController on {dev} (N="
          f"{cfg.prediction_horizon}, {cfg.max_iterations} rounds, a local sphere): modes "
          f"{' -> '.join(m.value for m in modes)} over {len(schedule)} ticks in {wall:.3f} s "
          f"(host clock); {replans} AUTONOMOUS replans, launches {launches} "
          f"({launches['B1'] / replans:g} of B1 a replan); its first replan vs method='torch': "
          f"positions max |diff| {dpos:.3g} m (1e-3); minimal_takeoff on {dev} (400 Hz ticks): "
          f"peak {takeoff['peak_altitude']:.3f} m, hover {takeoff['hover_altitude']:.3f} m, "
          f"final {takeoff['final_altitude']:.3f} m in {t_takeoff:.1f} s of wall", flush=True)
    return {"launches": launches["B1"], "per_replan": launches["B1"] / replans,
            "parity_m": dpos}


DEMO_SCENARIO, DEMO_REPLANS = "precision_landing", 10
DI_SCENARIO = "obstacle_avoidance"
# the keys of the JAX package's state_update frame (apps/web_demo.py) and of
# its drone_state
DEMO_FRAME_KEYS = {"type", "drone_state", "plan", "trajectory", "performance", "scenario",
                   "obstacles", "goal", "target", "status"}


@contextlib.contextmanager
def prediction_horizon_env(n: int):
    """``DART_PREDICTION_HORIZON=n`` for the port's frozen config while the
    block runs; the variable and the config singleton restored after."""
    import os

    from dart_planner_tpu_torch.config import reset_frozen_config

    saved = os.environ.get("DART_PREDICTION_HORIZON")
    os.environ["DART_PREDICTION_HORIZON"] = str(n)
    reset_frozen_config()
    try:
        yield
    finally:
        if saved is None:
            del os.environ["DART_PREDICTION_HORIZON"]
        else:
            os.environ["DART_PREDICTION_HORIZON"] = saved
        reset_frozen_config()


def di_planner_phase(dev, card: str) -> dict:
    """Phase 16a, the config path: the DI container's ``SE3MPCPlanner``,
    built from ``get_frozen_config().planning.to_se3_config()`` on the card,
    plans once from the web demo's ``obstacle_avoidance`` start with its
    spheres, with the launch counts set to 0 just before and read just
    after: 2 launches of B1, its positions within 1e-3 m of the plain path
    (15c's gate). Then a ``DART_PREDICTION_HORIZON=10`` override gives a
    planner with N=10, whose plan launches B1 too."""
    import torch

    from dart_planner_tpu_torch import DroneState
    from dart_planner_tpu_torch.apps.web_demo import DEMO_SCENARIOS
    from dart_planner_tpu_torch.common.di import create_default_container
    from dart_planner_tpu_torch.config import get_frozen_config, reset_frozen_config
    from dart_planner_tpu_torch.ops import cuda_mpc
    from dart_planner_tpu_torch.planning.se3_mpc import SE3MPCPlanner

    t_phase = time.perf_counter()
    sc = DEMO_SCENARIOS[DI_SCENARIO]
    reset_frozen_config()
    planner = create_default_container().resolve(SE3MPCPlanner)  # the card by default
    check(planner.device == dev, f"16a: the DI planner is on {planner.device}")
    check(planner.config == get_frozen_config().planning.to_se3_config(),
          "16a: the DI planner's config is not the frozen config's")
    for o in sc["obstacles"]:
        planner.add_obstacle(o["pos"], o["radius"])
    state = DroneState.create(position=sc["start_pos"], device=dev)
    rec = []
    restore = record_first_solve(rec)
    try:
        torch.cuda.synchronize()
        cuda_mpc.LAUNCHES = 0
        start = _event_pair()
        traj = planner.plan_trajectory(state, sc["goal_pos"])
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize()
        launches = cuda_mpc.LAUNCHES
    finally:
        restore()
    plan_ms = start.elapsed_time(end)
    check(launches == 2, f"16a: {launches} launches of B1 for the DI planner's plan, not 2")
    check(tuple(traj.positions.shape) == (planner.config.prediction_horizon, 3)
          and bool(torch.isfinite(traj.positions).all()), "16a: the plan is not finite (N, 3)")
    dpos = plain_gap(rec, "16a")
    check(dpos <= 1e-3, f"16a: the DI planner's plan, positions max |kernel - plain| "
          f"{dpos:.3g} m > 1e-3")
    with prediction_horizon_env(10):
        short = create_default_container().resolve(SE3MPCPlanner)
        check(short.config.prediction_horizon == 10 and short.device == dev,
              f"16a: the override gave N={short.config.prediction_horizon} on {short.device}")
        torch.cuda.synchronize()
        cuda_mpc.LAUNCHES = 0
        traj10 = short.plan_trajectory(state, sc["goal_pos"])
        torch.cuda.synchronize()
        launches10 = cuda_mpc.LAUNCHES
    check(launches10 == 2 and tuple(traj10.positions.shape) == (10, 3),
          f"16a: the N=10 planner launched B1 {launches10} times, plan "
          f"{tuple(traj10.positions.shape)}")
    print(f"[16a config] ({card}) {time.perf_counter() - t_phase:.1f} s (host clock); the DI "
          f"container's SE3MPCPlanner on {dev} from get_frozen_config().planning.to_se3_config() "
          f"(N={planner.config.prediction_horizon}, {planner.config.max_iterations} rounds, "
          f"two-phase), {DI_SCENARIO}'s start and {len(sc['obstacles'])} spheres: B1 launches "
          f"{launches}, the first plan {plan_ms:.3f} ms by CUDA events (cold), positions vs "
          f"method='torch' max |diff| {dpos:.3g} m (1e-3); DART_PREDICTION_HORIZON=10: N=10, "
          f"B1 launches {launches10}", flush=True)
    return {"launches": launches + launches10, "per_plan": launches, "parity_m": dpos}


def _post(port: int, path: str) -> int:
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status


def web_demo_phase(dev, card: str) -> dict:
    """Phase 16b, the web demo: ``DemoEngine`` on the card (``SE3MPCConfig()``,
    400 Hz ticks, 10 Hz replans) behind the demo's REST handler on a real
    ``ThreadingHTTPServer``, with a collecting in-process client in place of
    a websocket. ``POST /api/start/precision_landing``, DEMO_REPLANS
    ``state_update`` frames, then ``POST /api/stop``, with the launch counts
    set to 0 just before the start and read just after the stop. Checks: 2
    launches of B1 a replan, the frames of the JAX package's shape, 20 knots
    a plan, the vehicle's z decreasing, and the first replan's positions
    within 1e-3 m of the plain path (15c's gate). Times each replan on the
    host clock, from the plan's start to its frame's arrival, and each plan
    by CUDA events."""
    import asyncio
    import http.server
    import threading

    import numpy as np
    import torch

    from dart_planner_tpu_torch.apps import web_demo
    from dart_planner_tpu_torch.ops import cuda_mpc, cuda_rollout
    from dart_planner_tpu_torch.planning.se3_mpc import SE3MPCConfig, SE3MPCPlanner

    t_phase = time.perf_counter()
    engine = web_demo.DemoEngine()  # the card by default
    check(engine.device == dev, f"16b: the demo engine is on {engine.device}")
    plans, frames, rec = [], [], []
    plan_trajectory = SE3MPCPlanner.plan_trajectory

    def timed_plan(self, state, goal):
        t0, start = time.perf_counter(), _event_pair()
        out = plan_trajectory(self, state, goal)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        plans.append((t0, start, end))
        return out

    class Collect:
        """A websocket client's stand-in: keeps each frame with its arrival
        time (host clock)."""

        def __init__(self):
            self.done = asyncio.Event()

        async def send(self, payload):
            frames.append((time.perf_counter(), json.loads(payload)))
            if sum(m["type"] == "state_update" for _, m in frames) >= DEMO_REPLANS:
                self.done.set()

    async def fly():
        loop = asyncio.get_running_loop()
        httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                web_demo._make_handler(engine, loop))
        serving = threading.Thread(target=httpd.serve_forever, daemon=True)
        serving.start()
        client = Collect()
        engine.clients.add(client)
        try:
            port = httpd.server_address[1]
            torch.cuda.synchronize()
            cuda_mpc.LAUNCHES = cuda_rollout.LAUNCHES = 0
            t0 = time.perf_counter()
            status = await loop.run_in_executor(None, _post, port, f"/api/start/{DEMO_SCENARIO}")
            check(status == 200, f"16b: the start answered {status}")
            await asyncio.wait_for(client.done.wait(), timeout=300)
            status = await loop.run_in_executor(None, _post, port, "/api/stop")
            check(status == 200, f"16b: the stop answered {status}")
            torch.cuda.synchronize()
            return time.perf_counter() - t0, {"B1": cuda_mpc.LAUNCHES, "B2": cuda_rollout.LAUNCHES}
        finally:
            httpd.shutdown()
            serving.join(timeout=30)
            httpd.server_close()

    SE3MPCPlanner.plan_trajectory = timed_plan
    restore = record_first_solve(rec)
    try:
        wall, launches = asyncio.run(fly())
    finally:
        restore()
        SE3MPCPlanner.plan_trajectory = plan_trajectory
    check(not engine.is_running, "16b: the engine still runs after the stop")
    check(engine.planner.device == engine.mapper.device == engine.vehicle.device == dev,
          "16b: the engine's planner, mapper and vehicle are not all on the card")
    check(engine.planner.config == SE3MPCConfig(), "16b: the engine's planner config")
    updates = [(t, m) for t, m in frames if m["type"] == "state_update"]
    n_plans = engine.planner.get_planning_stats()["total_plans"]
    check(len(updates) >= DEMO_REPLANS and n_plans >= len(updates),
          f"16b: {len(updates)} frames for {n_plans} plans")
    check(launches == {"B1": 2 * n_plans, "B2": 0},
          f"16b: launches {launches} for {n_plans} replans, not 2 of B1 a replan")
    for _, m in updates:
        check(set(m) == DEMO_FRAME_KEYS and set(m["drone_state"]) == {"position", "velocity"},
              f"16b: a frame's keys {sorted(m)}")
        check(len(m["plan"]) == 20 and m["scenario"] == DEMO_SCENARIO,
              f"16b: a plan of {len(m['plan'])} knots for {m['scenario']}")
    z = [m["drone_state"]["position"][2] for _, m in updates]
    check(z[-1] < z[0] and all(b <= a + 1e-3 for a, b in zip(z, z[1:])),
          f"16b: the vehicle's z is not decreasing: {[round(v, 3) for v in z]}")
    dpos = plain_gap(rec, "16b")
    check(dpos <= 1e-3, f"16b: the demo's first replan, positions max |kernel - plain| "
          f"{dpos:.3g} m > 1e-3")
    check(np.array_equal(np.float32(updates[0][1]["plan"]), rec[0][4].cpu().numpy()),
          "16b: the first frame's plan is not the first solve's positions")
    replan_ms = [(t - p[0]) * 1e3 for (t, _), p in zip(updates, plans)]
    plan_ms = _elapsed([(s, e) for _, s, e in plans])
    rate = (len(updates) - 1) / (updates[-1][0] - updates[0][0])
    print(f"[16b web demo] ({card}) {time.perf_counter() - t_phase:.1f} s (host clock); "
          f"DemoEngine on {dev} (SE3MPCConfig(), 400 Hz ticks, 10 Hz replans, {DEMO_SCENARIO}) "
          f"behind the REST handler on a ThreadingHTTPServer, started and stopped over HTTP, "
          f"{wall:.3f} s from the start to the stop: {len(updates)} state_update frames of the "
          f"JAX shape, {n_plans} plans, launches {launches} (2 of B1 a replan), 20 knots a plan, "
          f"z {z[0]:.3f} -> {z[-1]:.3f} m; the first replan vs method='torch': positions max "
          f"|diff| {dpos:.3g} m (1e-3); a replan (host clock, the plan's start to its frame: "
          f"the plan, {engine.substeps} eager vehicle ticks, the map query, the broadcast) "
          f"{_pcts(replan_ms)}; a plan (CUDA events around plan_trajectory) {_pcts(plan_ms)}; "
          f"frames at {rate:.2f} Hz of wall (10 Hz asked)", flush=True)
    return {"launches": launches["B1"], "per_plan": launches["B1"] / n_plans,
            "parity_m": dpos,
            "replan_ms": [float(np.percentile(replan_ms, q)) for q in (50, 95)],
            "plan_ms": [float(np.percentile(plan_ms, q)) for q in (50, 95)],
            "frame_hz": rate}


MAVLINK_GOAL = (2.0, 0.0, 3.0)  # tests/test_hardware_mission.py's mocked mission
MAVLINK_TRAVEL_S = 3.0
MAVLINK_PROFILE_TICKS = 20
SECURE_GOAL = (2.0, 0.0, 3.0)
SECURE_TICKS = 400
PROCESS_LOOP_HZ, PROCESS_LOOP_S = 100.0, 1.0


class ScriptedMavlink:
    """Minimal pymavlink stand-in (a copy of tests/test_hardware_mission.py's
    ``_ScriptedMavlink``): heartbeats, COMMAND_ACKs, and a scripted
    LOCAL_POSITION_NED walk toward a target on the wall clock; it also
    records every SET_ATTITUDE_TARGET's arguments in ``targets`` and every
    COMMAND_LONG's in ``commands``."""

    class _Msg:
        def __init__(self, msg_type, **kw):
            self._t = msg_type
            self.__dict__.update(kw)

        def get_type(self):
            return self._t

    def __init__(self, goal_enu, travel_s=3.0, heartbeat_until=1e9):
        import numpy as np

        self.goal = np.asarray(goal_enu, float)
        self.start = np.array([0.0, 0.0, 2.0])
        self.travel_s = travel_s
        self.heartbeat_until = heartbeat_until
        self.t0 = None
        self._cycle = 0
        self.body_rate_targets = 0
        self.targets, self.commands = [], []
        self.target_system = 1
        self.target_component = 1
        self.mav = self  # .mav.* methods live on self

    # -- transport factory surface --
    def mavlink_connection(self, *a, **kw):
        return self

    def wait_heartbeat(self, timeout=None):
        self.t0 = time.time()
        return object()

    def close(self):
        pass

    # -- mav.* senders --
    def request_data_stream_send(self, *a):
        pass

    def command_long_send(self, *a):
        self.commands.append(a)

    def set_attitude_target_send(self, *a):
        self.body_rate_targets += 1
        self.targets.append(a)

    # -- receive side --
    def _pos_enu(self):
        u = min((time.time() - self.t0) / self.travel_s, 1.0)
        return self.start + u * (self.goal - self.start)

    def recv_match(self, type=None, blocking=False, timeout=None):
        if type == "COMMAND_ACK":
            return self._Msg("COMMAND_ACK", result=0)
        self._cycle = (self._cycle + 1) % 4
        if self._cycle == 1:
            p = self._pos_enu()
            v = (self.goal - self.start) / self.travel_s
            return self._Msg(
                "LOCAL_POSITION_NED",
                x=p[0], y=p[1], z=-p[2],  # adapter flips NED z -> ENU
                vx=v[0], vy=v[1], vz=-v[2],
            )
        if self._cycle == 2:
            return self._Msg(
                "ATTITUDE",
                roll=0.0, pitch=0.0, yaw=0.0,
                rollspeed=0.0, pitchspeed=0.0, yawspeed=0.0,
            )
        if self._cycle == 3 and time.time() - self.t0 < self.heartbeat_until:
            return self._Msg("HEARTBEAT")
        return None


class _TimedControlTicks:
    """``MissionRunner._control_tick`` patched on the class while a mission
    built by ``start_mission`` flies: CUDA events around each tick that
    sends a body-rate target (the vehicle's state onto the card, the
    arrival check's read, the smoother, the controller, the thrust's and
    the target's reads), and the runner kept for a later profile. Undone
    by ``restore``."""

    def __init__(self):
        from dart_planner_tpu_torch.hardware.mission import MissionRunner

        self.cls, self.tick = MissionRunner, MissionRunner._control_tick
        self.pairs, self.runner = [], None
        timed = self

        def control_tick(runner):
            import torch

            timed.runner = runner
            sent = runner.state.commands_sent
            start = _event_pair()
            timed.tick(runner)
            if runner.state.commands_sent > sent:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                timed.pairs.append((start, end))

        MissionRunner._control_tick = control_tick

    def restore(self):
        self.cls._control_tick = self.tick


def external_tick_profile(runner, ticks: int = MAVLINK_PROFILE_TICKS) -> dict:
    """What one external control tick issues, from a torch.profiler pass
    over ``ticks`` ticks of ``runner`` (its mission over, the runner made
    active, not done and aimed at a far waypoint again for the pass, its
    link still answering): device kernels, host reads (device-to-host
    copies), host writes (host-to-device copies) and top-level host ops,
    each a tick."""
    import asyncio

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # active again, not done, and aimed at a waypoint it does not reach, so
    # that each tick also reads the state for the arrival check as a
    # flying mission's does
    runner.state.active, runner.state.emergency = True, False
    runner._mission_done = asyncio.Event()
    runner._waypoints, runner.state.waypoint_index = [np.array([30.0, 0.0, 3.0])], 0
    try:
        for _ in range(3):
            runner._control_tick()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(ticks):
                runner._control_tick()
            torch.cuda.synchronize()
    finally:
        runner.state.active = False
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]

    def count(*words):
        return sum(1 for e in device if all(w in e.name.lower() for w in words))

    dtoh, htod = count("memcpy", "dtoh"), count("memcpy", "htod")
    copies = count("memcpy") + count("memset")
    ops = sum(1 for e in events if e.device_type == DeviceType.CPU and e.cpu_parent is None
              and e.name.startswith("aten::"))
    return {"kernels": (len(device) - copies) / ticks, "reads": dtoh / ticks,
            "writes": htod / ticks, "ops": ops / ticks}


def warm_external_tick(dev) -> float:
    """A plan and the external control tick, once each, on a runner and a
    planner of their own over a scripted link: the mission's first tick and
    plan must not hold the loop for a cold start (the link moves on the
    wall clock and its heartbeat ages meanwhile). Returns the first tick's
    host ms."""
    import asyncio

    import numpy as np
    import torch

    from dart_planner_tpu_torch.hardware.mavlink_adapter import MavlinkVehicleIO
    from dart_planner_tpu_torch.hardware.mission import MissionConfig, MissionRunner
    from dart_planner_tpu_torch.planning import se3_mpc

    vehicle = MavlinkVehicleIO({}, mavutil=ScriptedMavlink(MAVLINK_GOAL), device=dev)
    asyncio.run(vehicle.connect())
    runner = MissionRunner(vehicle, MissionConfig(), planner=se3_mpc.SE3MPCPlanner(device=dev))
    runner._waypoints = [np.asarray(MAVLINK_GOAL)]
    runner.state.active, runner._t0 = True, time.time()
    asyncio.run(runner._planning_tick())
    t0 = time.perf_counter()
    runner._control_tick()
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    for _ in range(3):
        runner._control_tick()
    torch.cuda.synchronize()
    return cold_ms


def mavlink_phase(dev, card: str) -> dict:
    """Phase 17a, the MAVLink mission: ``start_mission`` over the port's
    ``MavlinkVehicleIO`` on the card, its link the scripted stand-in
    (:class:`ScriptedMavlink`, the vehicle walking to MAVLINK_GOAL in
    MAVLINK_TRAVEL_S of wall clock), at the default ``MissionConfig`` (400 Hz
    control, 50 Hz planning, 0.5 s heartbeat timeout) with a 60 s mission
    timeout and an ``SE3MPCPlanner`` at the default config on the card;
    the launch counts set to 0 just before and read just after. Every plan
    is timed by CUDA events around ``plan_trajectory``, every control tick
    likewise (:class:`_TimedControlTicks`); the first solve is held
    against the plain path. Phase 17b: the same link stops heartbeating
    after 0.5 s, and the safety monitor must ground a mission toward a
    far goal with 'heartbeat lost'."""
    import asyncio

    import numpy as np
    import torch

    from dart_planner_tpu_torch.hardware.mavlink_adapter import MavlinkVehicleIO
    from dart_planner_tpu_torch.hardware.mission import (MissionConfig, MissionRunner,
                                                        start_mission)
    from dart_planner_tpu_torch.ops import cuda_mpc, cuda_rollout
    from dart_planner_tpu_torch.planning import se3_mpc

    t_phase = time.perf_counter()
    cold_ms = warm_external_tick(dev)
    link = ScriptedMavlink(MAVLINK_GOAL, travel_s=MAVLINK_TRAVEL_S)
    vehicle = MavlinkVehicleIO({"connection_string": "udp:mock"}, mavutil=link, device=dev)
    check(vehicle.device == dev, f"17a: the vehicle is on {vehicle.device}")
    config = MissionConfig(mission_timeout_s=60.0)
    planner = se3_mpc.SE3MPCPlanner(device=dev)
    plan_pairs, rec = [], []
    plan = planner.plan_trajectory

    def timed_plan(state, goal):
        start = _event_pair()
        traj = plan(state, goal)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        plan_pairs.append((start, end))
        return traj

    planner.plan_trajectory = timed_plan

    async def fly():
        await vehicle.connect()
        torch.cuda.synchronize()
        cuda_mpc.LAUNCHES = cuda_rollout.LAUNCHES = 0
        t0 = time.perf_counter()
        report = await start_mission(vehicle, [MAVLINK_GOAL], config=config, planner=planner)
        torch.cuda.synchronize()
        return report, time.perf_counter() - t0, {"B1": cuda_mpc.LAUNCHES,
                                                  "B2": cuda_rollout.LAUNCHES}

    ticks = _TimedControlTicks()
    restore = record_first_solve(rec)
    try:
        report, wall, launches = asyncio.run(fly())
    finally:
        restore()
        ticks.restore()
    plan_ms, tick_ms = _elapsed(plan_pairs), _elapsed(ticks.pairs)
    plans = len(plan_ms)
    ctl = report["scheduler"]["tasks"]["control"]
    check(report["mission_complete"] and report["waypoints_reached"] == 1,
          f"17a: the MAVLink mission did not complete: {report}")
    check(report["planning_failures"] == 0 and planner.emergency_plans == 0,
          f"17a: {report['planning_failures']} planning failures, "
          f"{planner.emergency_plans} emergency plans")
    sent = np.array([a[5:9] for a in link.targets], np.float64)
    check(len(sent) > 10 and np.isfinite(sent).all(),
          f"17a: {len(sent)} body-rate targets sent, finite: {np.isfinite(sent).all()}")
    check(plans > 0 and plans == len(ticks.runner.state.planning_times_ms),
          f"17a: {plans} calls of plan_trajectory, "
          f"{len(ticks.runner.state.planning_times_ms)} plans recorded")
    check(launches == {"B1": 2 * plans, "B2": 0},
          f"17a: launches {launches}, not 2 x {plans} plans of B1 and none of B2")
    dpos = plain_gap(rec, "17a")
    check(dpos <= 1e-3, f"17a: the first MAVLink plan, positions max |kernel - plain| "
          f"{dpos:.3g} m > 1e-3")
    per_tick = external_tick_profile(ticks.runner)
    print(f"[17a mavlink mission] ({card}) start_mission over MavlinkVehicleIO on {dev} (a "
          f"scripted link, the vehicle at {MAVLINK_GOAL} after {MAVLINK_TRAVEL_S:g} s), "
          f"MissionConfig(mission_timeout_s=60) (control {config.control_frequency:.0f} Hz, "
          f"planning {config.planning_frequency:.0f} Hz, heartbeat "
          f"{config.heartbeat_timeout_s:g} s), SE3MPCConfig(), after a warm-up (the first "
          f"external tick {cold_ms:.1f} ms, host clock): complete, "
          f"{report['waypoints_reached']} waypoint, {plans} plans, launches {launches} "
          f"({launches['B1'] / plans:g} of B1 a plan), {len(sent)} body-rate targets sent, "
          f"all finite; wall {wall:.3f} s; plan (CUDA events around plan_trajectory) "
          f"{_pcts(plan_ms)}; external control tick (CUDA events around the runner's tick: "
          f"the state onto the card, smoother, controller, the host reads) {_pcts(tick_ms)}; "
          f"a tick {per_tick['kernels']:.0f} kernel launches, {per_tick['reads']:.0f} host "
          f"reads, {per_tick['writes']:.0f} host writes and {per_tick['ops']:.0f} top-level "
          f"host ops (torch.profiler over "
          f"{MAVLINK_PROFILE_TICKS} ticks); control task: {ctl['execution_count']} ticks at "
          f"{ctl.get('achieved_frequency_hz', 0.0):.1f} Hz achieved of "
          f"{config.control_frequency:.0f}, {ctl['overruns']} overruns (host clock); the first "
          f"plan vs method='torch': positions max |diff| {dpos:.3g} m (1e-3)", flush=True)

    # -- 17b: the heartbeat-loss failsafe --------------------------------
    t1 = time.perf_counter()
    dead = ScriptedMavlink((30.0, 0.0, 3.0), travel_s=1e6, heartbeat_until=0.5)

    async def lose_link():
        v = MavlinkVehicleIO({"connection_string": "udp:mock"}, mavutil=dead, device=dev)
        await v.connect()
        runner = MissionRunner(v, MissionConfig(heartbeat_timeout_s=1.0, mission_timeout_s=60.0),
                               planner=planner)
        return await runner.start_mission([(30.0, 0.0, 3.0)])

    planner.plan_trajectory = plan
    lost = asyncio.run(lose_link())
    check(not lost["mission_complete"] and lost["failsafe_reason"] == "heartbeat lost",
          f"17b: the heartbeat-loss mission: complete {lost['mission_complete']}, "
          f"failsafe {lost['failsafe_reason']!r}")
    print(f"[17b heartbeat loss] ({card}) the link's heartbeats stop after 0.5 s: failsafe "
          f"{lost['failsafe_reason']!r}, mission complete {lost['mission_complete']}, "
          f"{lost['commands_sent']} body-rate targets before it, "
          f"{time.perf_counter() - t1:.1f} s (host clock); phase 17a-b "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"launches": launches["B1"], "plans": plans, "per_plan": launches["B1"] / plans,
            "parity_m": dpos, "plan_ms": plan_ms, "tick_ms": tick_ms, "wall_s": wall,
            "control_hz": ctl.get("achieved_frequency_hz", 0.0), "per_tick": per_tick,
            "cold_ms": cold_ms}


def secure_phase(dev, card: str) -> dict:
    """Phase 17c, the secure channel: ``SecureHardwareInterface`` over
    ``SimulatedVehicleIO`` on the card and a fresh ``AuthManager`` with an
    operator and a viewer. The operator's RS256 token connects, arms and
    takes off, and the vehicle climbs SECURE_TICKS ticks of its takeoff
    plan (from the ground the planner returns its hover plan); a plan from
    the vehicle's state to SECURE_GOAL by
    ``SE3MPCPlanner`` on the card (the launch counts set to 0 just before
    and read just after; held against the plain path) is uploaded through
    ``send_secure_command(..., "send_trajectory", ...)``, and the vehicle
    flies SECURE_TICKS ticks of it. Then the gate: the viewer's ``arm`` is
    refused and audited 'denied'; after an emergency stop an upload is
    audited 'blocked_estop'; disengaging takes the operator's password."""
    import asyncio

    import numpy as np
    import torch

    from dart_planner_tpu_torch.common.device import to_host
    from dart_planner_tpu_torch.common.errors import SecurityError
    from dart_planner_tpu_torch.hardware.secure_interface import SecureHardwareInterface
    from dart_planner_tpu_torch.hardware.simulated_vehicle import SimulatedVehicleIO
    from dart_planner_tpu_torch.ops import cuda_mpc, cuda_rollout
    from dart_planner_tpu_torch.planning import se3_mpc
    from dart_planner_tpu_torch.security.auth import AuthManager, Role

    t_phase = time.perf_counter()
    auth = AuthManager()
    auth.register_user("op", "pw-op-123", Role.OPERATOR)
    auth.register_user("watch", "pw-watch-1", Role.VIEWER)
    op = auth.create_access_token(auth.authenticate("op", "pw-op-123"))
    viewer = auth.create_access_token(auth.authenticate("watch", "pw-watch-1"))
    vehicle = SimulatedVehicleIO(device=dev)
    check(vehicle.device == dev, f"17c: the vehicle is on {vehicle.device}")
    shi = SecureHardwareInterface(vehicle, auth)
    planner = se3_mpc.SE3MPCPlanner(device=dev)
    goal = np.asarray(SECURE_GOAL)
    rec = []

    async def fly():
        check(await shi.connect(op), "17c: connect refused")
        check(await shi.send_secure_command(op, "arm"), "17c: arm failed")
        check(await shi.send_secure_command(op, "takeoff", {"altitude": 2.0}),
              "17c: takeoff failed")
        for _ in range(SECURE_TICKS):
            vehicle.step()
        state = vehicle.get_state()
        start_gap = float(np.linalg.norm(to_host(state.position) - goal))
        torch.cuda.synchronize()
        cuda_mpc.LAUNCHES = cuda_rollout.LAUNCHES = 0
        restore = record_first_solve(rec)
        try:
            t0 = _event_pair()
            traj = planner.plan_trajectory(state, SECURE_GOAL)
            t1 = torch.cuda.Event(enable_timing=True)
            t1.record()
            torch.cuda.synchronize()
        finally:
            restore()
        launches = {"B1": cuda_mpc.LAUNCHES, "B2": cuda_rollout.LAUNCHES}
        check(await shi.send_secure_command(op, "send_trajectory", {"trajectory": traj}),
              "17c: the trajectory upload failed")
        w0 = time.perf_counter()
        for _ in range(SECURE_TICKS):
            vehicle.step()
        end = to_host(vehicle.get_state().position)
        flight_s = time.perf_counter() - w0
        # the gate
        try:
            await shi.send_secure_command(viewer, "arm")
            check(False, "17c: the viewer's arm was accepted")
        except SecurityError:
            pass
        check(await shi.emergency_stop(viewer), "17c: the emergency stop failed")
        try:
            await shi.send_secure_command(op, "send_trajectory", {"trajectory": traj})
            check(False, "17c: a trajectory upload passed the engaged emergency stop")
        except SecurityError:
            pass
        try:
            shi.disengage_emergency_stop(op, "op", "wrong")
            check(False, "17c: the emergency stop disengaged without re-authentication")
        except SecurityError:
            pass
        check(shi.disengage_emergency_stop(op, "op", "pw-op-123"),
              "17c: re-authenticated disengage refused")
        return start_gap, end, t0.elapsed_time(t1), launches, flight_s

    start_gap, end, plan_ms, launches, flight_s = asyncio.run(fly())
    end_gap = float(np.linalg.norm(end - goal))
    audit = [(e["command_type"], e["status"]) for e in shi.get_command_audit_log(op)]
    check(launches == {"B1": 2, "B2": 0}, f"17c: launches {launches} for one plan, not 2 of B1")
    dpos = plain_gap(rec, "17c")
    check(dpos <= 1e-3, f"17c: the uploaded plan, positions max |kernel - plain| "
          f"{dpos:.3g} m > 1e-3")
    check(planner.emergency_plans == 0, "17c: the planner returned its hover plan")
    check(np.isfinite(end).all() and end_gap < start_gap,
          f"17c: the vehicle ended {end_gap:.3f} m from the goal, from {start_gap:.3f}")
    for entry in (("send_trajectory", "executed"), ("arm", "denied"),
                  ("send_trajectory", "blocked_estop"), ("disengage_estop", "denied"),
                  ("disengage_estop", "executed")):
        check(entry in audit, f"17c: {entry} not in the audit log {audit}")
    print(f"[17c secure channel] ({card}) SecureHardwareInterface over SimulatedVehicleIO on "
          f"{dev}, RS256 tokens (an operator, a viewer): connect, arm, takeoff and "
          f"{SECURE_TICKS} ticks of its climb, a plan to "
          f"{SECURE_GOAL} (SE3MPCConfig(), {plan_ms:.3f} ms by CUDA events, launches "
          f"{launches}) uploaded through send_secure_command; {SECURE_TICKS} ticks in "
          f"{flight_s:.3f} s (host clock): {start_gap:.3f} -> {end_gap:.3f} m from the goal; "
          f"the plan vs method='torch': positions max |diff| {dpos:.3g} m (1e-3); the "
          f"viewer's arm denied, an upload under the emergency stop blocked_estop, disengage "
          f"refused without the password and done with it; {len(audit)} audit entries, "
          f"{time.perf_counter() - t_phase:.1f} s (host clock)", flush=True)
    return {"launches": launches["B1"], "per_plan": launches["B1"], "parity_m": dpos,
            "plan_ms": plan_ms, "vehicle": vehicle}


class MockAirSimClient:
    """An AirSim RPC client stand-in (tests/test_hardware_extended.py's, with a
    tilted, yawed orientation and non-zero rates): it records every call."""

    class _Future:
        def join(self):
            return None

    def __init__(self):
        self.calls = []
        self.api_control = False
        self.armed = False

    def confirmConnection(self):
        self.calls.append("confirm")

    def enableApiControl(self, on, name=""):
        self.api_control = on

    def armDisarm(self, arm, name=""):
        self.armed = arm

    def getMultirotorState(self, name=""):
        import math
        from types import SimpleNamespace

        def vec(x, y, z):
            return SimpleNamespace(x_val=x, y_val=y, z_val=z)

        # NED roll 0.1, pitch -0.2, yaw 0.7, composed as AirSim's quaternion
        r, p, y = 0.05, -0.1, 0.35
        quat = SimpleNamespace(
            w_val=math.cos(r) * math.cos(p) * math.cos(y) + math.sin(r) * math.sin(p) * math.sin(y),
            x_val=math.sin(r) * math.cos(p) * math.cos(y) - math.cos(r) * math.sin(p) * math.sin(y),
            y_val=math.cos(r) * math.sin(p) * math.cos(y) + math.sin(r) * math.cos(p) * math.sin(y),
            z_val=math.cos(r) * math.cos(p) * math.sin(y) - math.sin(r) * math.sin(p) * math.cos(y))
        return SimpleNamespace(kinematics_estimated=SimpleNamespace(
            position=vec(1.25, 2.5, -3.125),
            linear_velocity=vec(0.1, 0.2, -0.3),
            angular_velocity=vec(0.01, -0.02, 0.03),
            orientation=quat))

    def moveByAngleRatesThrottleAsync(self, *a, **kw):
        self.calls.append(("rates", a))
        return self._Future()

    def takeoffAsync(self, **kw):
        self.calls.append("takeoff")
        return self._Future()

    def moveToZAsync(self, *a, **kw):
        self.calls.append(("z", a))
        return self._Future()

    def landAsync(self, **kw):
        self.calls.append("land")
        return self._Future()

    def hoverAsync(self, name=""):
        self.calls.append("hover")
        return self._Future()

    def simPause(self, on):
        self.calls.append(("pause", on))


def airsim_phase(dev, card: str) -> None:
    """Phase 17d: ``AirSimVehicleIO`` over :class:`MockAirSimClient` on the
    card connects, takes off, polls and lands, and sends one control
    command; the polled state equals the CPU adapter's bit for bit (the
    timestamps aside), and both send the same command."""
    import asyncio

    import torch

    from dart_planner_tpu_torch.common.types import ControlCommand
    from dart_planner_tpu_torch.hardware.airsim_interface import AirSimVehicleIO

    async def drive(device):
        client = MockAirSimClient()
        vio = AirSimVehicleIO(client=client, device=device)
        await vio.connect()
        await vio.takeoff(3.0)
        st = await vio.poll_state()
        cmd = ControlCommand(thrust=torch.tensor(12.5, device=device),
                             torque=torch.tensor([0.1, -0.2, 0.3], device=device))
        sent = await vio.iface.send_control_command(cmd)
        await vio.land()
        return vio, st, sent, client

    vio, st, sent, client = asyncio.run(drive(dev))
    _, cpu, cpu_sent, cpu_client = asyncio.run(drive("cpu"))
    fields = ("position", "velocity", "attitude", "angular_velocity")
    check(all(getattr(st, f).device == dev for f in fields), "17d: the state is not on the card")
    same = all(torch.equal(getattr(st, f).cpu(), getattr(cpu, f)) for f in fields)
    check(same, "17d: the card's polled state differs from the CPU adapter's")
    check(sent and cpu_sent and client.calls == cpu_client.calls,
          f"17d: commands {client.calls} vs the CPU's {cpu_client.calls}")
    check(not vio.iface.armed and vio.get_status()["connected"],
          f"17d: status after landing {vio.get_status()}")
    print(f"[17d airsim] ({card}) AirSimVehicleIO over a mock client on {dev}: connect, "
          f"takeoff, poll, one control command, land; the polled state equals the CPU "
          f"adapter's bit for bit (position {st.position.cpu().tolist()}, attitude "
          f"{st.attitude.cpu().tolist()}), the same {len(client.calls)} client calls",
          flush=True)


def _loop_fn(state):
    """The process loop's host function (module level: no closure over the
    parent's tensors): speed and altitude of a host state."""
    import numpy as np

    return {"speed": float(np.linalg.norm(state["velocity"])),
            "altitude": float(state["position"][2])}


def process_loop_phase(dev, card: str, vehicle) -> None:
    """Phase 17e: with CUDA started in this process, ``ProcessControlLoop``
    runs :func:`_loop_fn` on the host at PROCESS_LOOP_HZ for PROCESS_LOOP_S,
    fed a ``DroneState`` read from the card through ``to_host``; it returns
    outputs, reports no error, and stops."""
    from dart_planner_tpu_torch.common.device import to_host
    from dart_planner_tpu_torch.runtime.multiprocess_loop import ProcessControlLoop

    st = vehicle.get_state()
    check(st.position.device == dev, f"17e: the state is on {st.position.device}")
    host = {k: to_host(getattr(st, k)) for k in ("position", "velocity")}
    loop = ProcessControlLoop(_loop_fn, frequency_hz=PROCESS_LOOP_HZ)
    t0 = time.perf_counter()
    loop.start()
    try:
        loop.send_state(host)
        outputs = 0
        while time.perf_counter() - t0 < PROCESS_LOOP_S:
            before = loop.last_output
            out = loop.get_output(timeout=0.05)
            outputs += out is not None and out is not before
        running = loop.running
    finally:
        loop.stop()
    want = _loop_fn(host)
    check(loop.error is None, f"17e: the process loop reported {loop.error}")
    check(running and not loop.running, f"17e: running {running}, after stop {loop.running}")
    check(loop.last_output == want, f"17e: output {loop.last_output}, expected {want}")
    print(f"[17e process loop] ({card}) ProcessControlLoop at {PROCESS_LOOP_HZ:g} Hz for "
          f"{PROCESS_LOOP_S:g} s after CUDA started here, fed the secure phase's state read "
          f"from {dev}: {outputs} output reads, last {loop.last_output}, no error, stopped; "
          f"{time.perf_counter() - t0:.2f} s (host clock)", flush=True)


# the long horizons of phase 18: one CG-2 round at the third slot's first
# step (65), inside it (80), in the fourth slot (100) and at a full fourth
# slot (128); the full solve and the front door at 80 and 100; the times at
# the default horizon, two slots, three and four
LONG_ROUND_HORIZONS = (65, 80, 100, 128)
LONG_SOLVE_HORIZONS = (80, 100)
TIMED_HORIZONS = (20, 40, 80, 100)
# the share of scenarios in which one CG-2 round of B1 may part from the
# plain loop beyond phase 3b's limits at N > 64: float32 near-ties at a CG
# break, the active set or the line search branch 1-3 scenarios of 4096 in
# a round there (as phase 3b's own N=20 config does at another seed)
LONG_ROUND_BRANCHES = 1e-3
# how far such a scenario may part: its largest thrust, position or velocity
# difference within 5x phase 3b's 2e-3, as 3b's own outliers are, and the
# exact costs of the two iterates within 10x 3b's 1e-4 (a branch that moves
# the thrusts by 7e-3 N moves the exact cost by up to 5.6e-4 relative,
# N=65 at full curvature). A fault in whole blocks parts them by newtons.
LONG_ROUND_OUTLIER_DX = 5 * 2e-3
LONG_ROUND_OUTLIER_COST = 10 * 1e-4


def share_within(x, limit: float, share: float, factor: float = 5.0) -> bool:
    """All but ``share`` of ``x`` within ``limit``, and every value within
    ``factor`` times it."""
    return float((x > limit).float().mean()) <= share and float(x.max()) <= factor * limit


def _scenarios_apart(a, ea, p, ep):
    """Per scenario: the largest |a - p| of the thrusts, positions and
    velocities of two solver outputs, the relative difference of their
    iterates' exact costs ``ea`` and ``ep``, and |a - p| of their smallest
    relative improvements (output 1, which decides the converged flags)
    over 1 + |p|: the improvement (cost(u0) - cost(u)) / (1 + |cost(u)|)
    moves by that much when each cost moves by as much relative."""
    import torch

    dx = torch.stack([(a[i] - p[i]).abs().amax((-1, -2)) for i in (0, 2, 3)]).amax(0)
    di = (a[1] - p[1]).abs() / (1.0 + p[1].abs())
    return dx.reshape(-1), ((ea - ep).abs() / ep.abs()).reshape(-1), di.reshape(-1)


def b1_round_scenarios(cfg_r, prob, u0, with_cpu: bool = False) -> dict:
    """One launch of kernel B1 against ``solve_thrusts_plain`` on the same
    inputs, scenario by scenario: the largest |kernel - plain| of each
    scenario's thrusts, positions and velocities, the relative difference
    of the two iterates' exact (float64) costs, |kernel - plain| of the
    smallest relative improvement, and the kernel's cost against the exact
    cost of its own thrusts. A scenario is apart when it is beyond phase
    3b's limits (2e-3; 1e-4 relative, on the costs and the improvements,
    :func:`_scenarios_apart`). With ``with_cpu``, also the plain loop on the
    CPU against itself on the card, the same way: its own spread (``"cpu"``:
    scenarios apart, the largest differences)."""
    import torch

    from dart_planner_tpu_torch.ops import costs, cuda_mpc

    kr = cuda_mpc.solve_thrusts_fused(cfg_r, prob, u0)
    pr = cuda_mpc.solve_thrusts_plain(cfg_r, prob, u0)
    torch.cuda.synchronize()
    ek, ep = cuda_mpc.exact_cost(cfg_r, prob, kr[0]), cuda_mpc.exact_cost(cfg_r, prob, pr[0])
    dx, c_pl, di = _scenarios_apart(kr, ek, pr, ep)
    ek, ep, ck, cp = (x.reshape(-1) for x in (ek, ep, kr[4].double(), pr[4].double()))
    c_own = (ck - ek).abs() / ek.abs()
    apart = ((dx > 2e-3) | (c_pl > 1e-4) | (di > 1e-4)).nonzero().flatten().tolist()
    out = {"finite": all(bool(torch.isfinite(x).all()) for x in kr), "B": dx.numel(),
           "dx": float(dx.max()), "c_pl": float(c_pl.max()), "di": float(di.max()),
           "c_own": c_own, "dx_all": dx, "c_all": c_pl, "di_all": di,
           "c_plain_own": float(((cp - ep).abs() / ep.abs()).max()),
           "apart": [(i, float(dx[i]), float(c_pl[i]), float(ek[i]), float(ep[i]))
                     for i in apart]}
    if with_cpu:
        cpu = costs.Problem(*[None if x is None else x.cpu() for x in prob])
        cr = [x.to(u0.device) for x in cuda_mpc.solve_thrusts_plain(cfg_r, cpu, u0.cpu())]
        dx_c, c_c, di_c = _scenarios_apart(cr, cuda_mpc.exact_cost(cfg_r, prob, cr[0]), pr, ep)
        out["cpu"] = {"n_apart": int(((dx_c > 2e-3) | (c_c > 1e-4) | (di_c > 1e-4)).sum()),
                      "dx": float(dx_c.max()), "c_pl": float(c_c.max()),
                      "di": float(di_c.max())}
    return out


def check_round_scenarios(tag: str, e: dict, allowed: float = None,
                          dx_cap: float = LONG_ROUND_OUTLIER_DX,
                          cost_cap: float = LONG_ROUND_OUTLIER_COST) -> str:
    """Phase 3b's limits (2e-3; 1e-4 relative on the exact costs and on
    the smallest relative improvements) in all but ``allowed`` scenarios
    (default LONG_ROUND_BRANCHES of them), and every scenario within
    ``dx_cap``, and ``cost_cap`` on both the costs and the improvements; the
    kernel's cost within 1e-5 of the exact cost of its own thrusts in all
    but 1e-3 of them and within 5e-5 in every one. Returns the line."""
    c_own = e["c_own"]
    n_apart = int(((e["dx_all"] > 2e-3) | (e["c_all"] > 1e-4) | (e["di_all"] > 1e-4)).sum())
    if allowed is None:
        allowed = LONG_ROUND_BRANCHES * e["B"]
    line = (f"{n_apart} of {e['B']} scenarios apart (beyond 2e-3, or 1e-4 rel in exact "
            f"costs or improvements; max |dx| {e['dx']:.3g}, cost rel {e['c_pl']:.3g}, "
            f"improvement rel {e['di']:.3g}"
            + "".join(f"; scenario {i}: |dx| {d:.3g}, exact cost kernel {a:.9g} plain {b:.9g}"
                      for i, d, _, a, b in e["apart"][:3])
            + f"); cost vs the exact cost of own thrusts p99.9 "
              f"{float(c_own.quantile(0.999)):.3g} max {float(c_own.max()):.3g} (the plain "
              f"loop's float32 cost: max {e['c_plain_own']:.3g})")
    check(e["finite"], f"{tag}: non-finite kernel output")
    check(n_apart <= allowed,
          f"{tag}: {n_apart} of {e['B']} scenarios beyond phase 3b's limits (allowed "
          f"{allowed:g}): {line}")
    check(e["dx"] <= dx_cap and e["c_pl"] <= cost_cap and e["di"] <= cost_cap,
          f"{tag}: a scenario beyond {dx_cap:g}, or exact costs or improvements "
          f"{cost_cap:g} apart: {line}")
    check(share_within(c_own, 1e-5, 1e-3), f"{tag}: {line}")
    return line


# how much smaller the share of scenarios in which B1's iterate stays
# within phase 3b's limits of the plain loop's may be than the share in
# which the plain loop on the CPU stays within them of itself on the card,
# after a few rounds: the two shares differ by at most 0.0052 at N = 20-100
# (my chip run, PR 10, call 13), while a fault in any round parts most
# scenarios
ROUNDS_CLOSE_SHORTFALL = 0.02
# the budgets past one round that phase 18b runs: CG-4 keeps 80-99% of the
# scenarios within phase 3b's limits at N <= 100; CG-8 parts ~90% of them
# in float32 at any horizon (the plain loop from itself as well)
ROUND_BUDGETS = ((2, 4), (3, 8))


def b1_rounds(config, prob, rounds: int, cg: int) -> dict:
    """``rounds`` Newton rounds at CG-``cg`` of kernel B1 against
    ``solve_thrusts_plain`` from the cold start, a budget past one round so
    that a fault from round 2 on shows. Held to the aggregate contract of
    the JAX package's large-horizon test (as
    tests/test_torch_cuda_mpc.py::test_cuda_kernel_obstacles_aggregate):
    finite, inside the thrust bounds, every scenario's exact cost at or
    below its cold start's, the exact mean costs within 5% of each other;
    and scenario by scenario against the plain loop's own spread: the share
    of scenarios within phase 3b's limits of the plain loop's iterate no
    more than ROUNDS_CLOSE_SHORTFALL below the share in which the plain
    loop on the CPU stays within them of itself on the card."""
    import torch

    from dart_planner_tpu_torch.ops import costs, cuda_mpc
    from dart_planner_tpu_torch.planning import se3_mpc

    N = config.prediction_horizon
    tag = f"18b N={N} {rounds} rounds CG-{cg}"
    cfg = config._replace(max_iterations=rounds, cg_iterations=cg, tail_iterations=0)
    u0 = se3_mpc.initialize_thrusts(cfg, prob)
    k = cuda_mpc.solve_thrusts_fused(cfg, prob, u0)
    p = cuda_mpc.solve_thrusts_plain(cfg, prob, u0)
    cpu = costs.Problem(*[None if x is None else x.cpu() for x in prob])
    c = [x.to(u0.device) for x in cuda_mpc.solve_thrusts_plain(cfg, cpu, u0.cpu())]
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(x).all()) for x in k), f"{tag}: non-finite kernel output")
    lb, ub = cfg.thrust_bounds(device=u0.device)
    check(bool(((k[0] >= lb - 1e-5) & (k[0] <= ub + 1e-5)).all()),
          f"{tag}: thrusts outside thrust_bounds")
    e0, ek, ep, ec = (cuda_mpc.exact_cost(cfg, prob, u) for u in (u0, k[0], p[0], c[0]))
    rise = float(((ek - e0) / e0).max())

    def close(a, ea):  # the share of scenarios within phase 3b's limits of the plain loop's
        dx = torch.stack([(a[i] - p[i]).abs().amax((-1, -2)) for i in (0, 2, 3)]).amax(0)
        return float(((dx <= 2e-3) & ((ea - ep).abs() / ep <= 1e-4)).double().mean())

    mk, mp, mc = float(ek.mean()), float(ep.mean()), float(ec.mean())
    out = {"mean_cost_rel": abs(mk - mp) / mp, "mean_cost_rel_plain_cpu": abs(mc - mp) / mp,
           "largest_rise": rise, "close_share": close(k, ek),
           "close_share_plain_cpu": close(c, ec),
           "converged": float((k[1] <= cfg.ftol).float().mean()),
           "converged_plain": float((p[1] <= cfg.ftol).float().mean())}
    line = (f"scenarios within phase 3b's limits of the plain loop's: kernel "
            f"{out['close_share']:.4f}, the plain loop on the CPU "
            f"{out['close_share_plain_cpu']:.4f} (shortfall allowed {ROUNDS_CLOSE_SHORTFALL}); "
            f"exact mean cost {mk:.6g} (plain {mp:.6g}, rel {out['mean_cost_rel']:.3g}; the "
            f"plain loop on the CPU {mc:.6g}, rel {out['mean_cost_rel_plain_cpu']:.3g}; 5%), "
            f"largest rise over the cold start {rise:.3g} (0; 1e-6 for float32 ties); "
            f"converged {out['converged']:.4f} (plain {out['converged_plain']:.4f})")
    check(rise <= 1e-6, f"{tag}: a scenario's exact cost rose over its cold start: {line}")
    check(mk <= 1.05 * mp and mp <= 1.05 * mk, f"{tag}: mean costs apart: {line}")
    check(out["close_share"] >= out["close_share_plain_cpu"] - ROUNDS_CLOSE_SHORTFALL,
          f"{tag}: B1 parts from the plain loop more often than the plain loop from itself: "
          f"{line}")
    print(f"[{tag}] B={u0.shape[0]}, kernel vs plain: {line}", flush=True)
    return out


def solve_within_spread(tag: str, cfg, prob) -> tuple:
    """The two-phase ``solve(method="auto")`` on ``prob`` with the launch
    count set to 0 just before and read just after: 2 launches, finite
    thrusts inside their bounds, the kernel's costs against the exact costs
    of its thrusts; its converged share and mean cost against
    ``solve(method="torch")`` on the card within the plain path's own
    spread between the CPU and the card (at least phase 11's 0.002 and 1e-3,
    which float32 does not hold past 64 steps, ROADMAP C.21): the mean cost
    within twice that pair's difference, the share within twice that pair's
    difference or three standard deviations of a share whose F flags flip
    at random, 3 sqrt(F) / B with F the pair's flags apart, whichever is
    larger. Returns (the launches, the record)."""
    import torch

    from dart_planner_tpu_torch.ops import costs, cuda_mpc
    from dart_planner_tpu_torch.planning import se3_mpc

    dev = prob.p0.device
    torch.cuda.synchronize()
    cuda_mpc.LAUNCHES = 0
    res = se3_mpc.solve(cfg, prob, method="auto")
    torch.cuda.synchronize()
    n = cuda_mpc.LAUNCHES
    check(n == 2, f"{tag}: solve() launched B1 {n} times, not 2")
    for name, x in zip(res._fields, res):
        if x is not None and x.dtype.is_floating_point:
            check(bool(torch.isfinite(x).all()), f"{tag}: non-finite {name}")
    lb, ub = cfg.thrust_bounds(device=dev)
    check(bool(((res.thrusts >= lb - 1e-5) & (res.thrusts <= ub + 1e-5)).all()),
          f"{tag}: thrusts outside thrust_bounds")
    c_own = (res.cost.double() - cuda_mpc.exact_cost(cfg, prob, res.thrusts)).abs() / \
        res.cost.double().abs()
    check(share_within(c_own, 1e-5, 1e-3),
          f"{tag}: cost vs the exact cost of its thrusts p99.9 "
          f"{float(c_own.quantile(0.999)):.3g} max {float(c_own.max()):.3g}")
    ref = se3_mpc.solve(cfg, prob, method="torch")
    check(cuda_mpc.LAUNCHES == n, f"{tag}: the plain path launched B1")
    # the plain path against itself: the same solve on the CPU
    ref_cpu = se3_mpc.solve(cfg, costs.Problem(*[None if x is None else x.cpu()
                                                 for x in prob]), method="torch")
    conv, conv_p = float(res.converged.float().mean()), float(ref.converged.float().mean())
    conv_c = float(ref_cpu.converged.float().mean())
    # scenario by scenario: converged flags that differ from the card's
    # plain path's, the kernel's and the plain path's on the CPU
    flips = int((res.converged != ref.converged).sum())
    flips_c = int((ref_cpu.converged.to(dev) != ref.converged).sum())
    mc, mp, m_c = float(res.cost.mean()), float(ref.cost.mean()), float(ref_cpu.cost.mean())
    rel, rel_c = abs(mc - mp) / abs(mp), abs(m_c - mp) / abs(mp)
    held = abs(conv - conv_p) <= 0.002 and rel <= 1e-3
    # the plain path parts from itself across devices as far as phase
    # 11's limits are exceeded here (C.21): the kernel may part from it
    # by at most that spread, and never by more than phase 11's limits
    # where the spread is smaller. One pair's share difference is a single
    # draw of the flips' noise (0.0020 from 364 flips at N=160), so the
    # share's limit is also at least three of its standard deviations.
    B = res.converged.numel()
    lim_conv = max(0.002, 2 * abs(conv_c - conv_p), 3 * math.sqrt(flips_c) / B)
    lim_cost = max(1e-3, 2 * rel_c)
    rec = {"converged": conv, "converged_plain": conv_p, "converged_plain_cpu": conv_c,
           "flags_apart": flips, "flags_apart_plain_cpu": flips_c,
           "mean_cost": mc, "mean_cost_plain": mp, "mean_cost_plain_cpu": m_c,
           "within_phase11_limits": held,
           "limits": {"converged": lim_conv, "mean_cost_rel": lim_cost}}
    line = (f"converged {conv:.4f} (plain path {conv_p:.4f}, apart {abs(conv - conv_p):.4f}; "
            f"the plain path on the CPU {conv_c:.4f}, apart from the card's "
            f"{abs(conv_c - conv_p):.4f}; limit {lim_conv:.4f}), mean cost {mc:.6g} (plain "
            f"{mp:.6g}, rel {rel:.3g}; on the CPU {m_c:.6g}, rel {rel_c:.3g}; limit "
            f"{lim_cost:.3g}); converged flags unlike the card's plain path's: kernel {flips}, "
            f"the plain path on the CPU {flips_c} of {B}; phase 11's 0.002 and 1e-3: "
            + ("held" if held else "not held (ROADMAP C.21)"))
    check(abs(conv - conv_p) <= lim_conv and rel <= lim_cost,
          f"{tag}: the kernel's solve parts from the plain path by more than the "
          f"plain path's own spread across devices allows: {line}")
    print(f"[{tag}] solve(method='auto') B={prob.p0.shape[0]}: {n} launches, thrusts inside "
          f"their bounds, cost vs the exact cost of its thrusts p99.9 "
          f"{float(c_own.quantile(0.999)):.3g} max {float(c_own.max()):.3g}; {line}",
          flush=True)
    return n, rec


def ptxas_by_steps(log: str) -> dict:
    """Kernel B1's ptxas figures for each instantiation, keyed by the horizon
    steps a lane S: registers, stack frame and spill bytes, from the
    ``-Xptxas -v`` lines of the build log."""
    import re

    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            k = re.search(r"mpc_solve_kernelILi(\d+)E", m.group(1))
            cur = int(k.group(1)) if k else None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", ln)
        if m:
            out.setdefault(cur, {}).update(stack_bytes=int(m.group(1)),
                                           spill_stores=int(m.group(2)),
                                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.setdefault(cur, {})["registers"] = int(m.group(1))
    return out


def long_horizon_phase(dev, card: str) -> dict:
    """Phase 18 (18a-d): kernel B1 at three and four horizon steps a lane.

    18a: one Newton round at CG-2 with every hinge on, in both curvature
    modes, with and without a per-scenario v_cap, on the bench batch at each
    of LONG_ROUND_HORIZONS against the plain version, scenario by scenario
    (:func:`check_round_scenarios`). 18b: the two-phase ``solve()`` at the
    default budget at each of LONG_SOLVE_HORIZONS, B=4096, against the plain
    path within twice its own spread (:func:`solve_within_spread`); and each of
    ROUND_BUDGETS against the plain loop, to the aggregate contract and
    scenario by scenario against the plain loop's own spread
    (:func:`b1_rounds`).
    18c: the DI container's planner under ``DART_PREDICTION_HORIZON`` at the
    same horizons, on the card with N from the frozen config, 2 launches a
    plan, one CG-2 round of B1 on its recorded first problem against the
    plain version; its plan's gap to the plain path printed beside 16a's
    1e-3 m. 18d: the phase-1 solve at each of TIMED_HORIZONS, B=4096 and
    B=1: with the wrapper (CUDA events), the kernel alone (CUDA events
    around the launch), the plain version, the bound and the share of it
    reached; and B1's ptxas registers and spills for each instantiation (S = 1-4,
    and 5 for five or more steps a lane)."""
    import torch

    from dart_planner_tpu_torch import DroneState
    from dart_planner_tpu_torch.apps.web_demo import DEMO_SCENARIOS
    from dart_planner_tpu_torch.common import frames
    from dart_planner_tpu_torch.common.di import create_default_container
    from dart_planner_tpu_torch.config import get_frozen_config
    from dart_planner_tpu_torch.ops import _build, cuda_mpc
    from dart_planner_tpu_torch.planning import se3_mpc

    t_phase = time.perf_counter()
    base = se3_mpc.SE3MPCConfig()
    gvec = frames.gravity_vector(frames.WorldFrame.ENU, base.gravity, device=dev)
    err_rounds = []
    for N in LONG_ROUND_HORIZONS:
        cfg = base._replace(prediction_horizon=N, tail_iterations=0)
        prob = bench_problem(se3_mpc, cfg, B_BENCH, N, dev)
        u0 = se3_mpc.initialize_thrusts(cfg, prob)
        probv = prob._replace(v_cap=torch.full((B_BENCH,), 3.0, dtype=torch.float32,
                                               device=dev))
        for label, pr in (("static", prob), ("v_cap=3", probv)):
            act = hinge_activity(cfg, pr, u0, gvec)
            check(all(n > 0 for n in act.values()),
                  f"18a N={N} {label}: some hinge inactive at the cold start {act}")
            for stage, n_gn in (("GN", 1), ("full", 0)):
                cfg_r = cfg._replace(max_iterations=1, cg_iterations=2, gn_warmup_iterations=n_gn)
                tag = f"18a N={N} one round {label} {stage}"
                e = b1_round_scenarios(cfg_r, pr, u0)
                print(f"[{tag}] B={B_BENCH} CG-2, active scenarios {act}: "
                      f"{check_round_scenarios(tag, e)}", flush=True)
                err_rounds.append(e["dx"])

    launches = 0
    solves, rounds = {}, {}
    for N in LONG_SOLVE_HORIZONS:
        cfg = base._replace(prediction_horizon=N)
        prob = bench_problem(se3_mpc, cfg, B_BENCH, N, dev)
        n, solves[N] = solve_within_spread(f"18b N={N}", cfg, prob)
        launches += n
        rounds[N] = {f"{r}x{cg}": b1_rounds(cfg, prob, r, cg) for r, cg in ROUND_BUDGETS}

    sc = DEMO_SCENARIOS[DI_SCENARIO]
    state = DroneState.create(position=sc["start_pos"], device=dev)
    di = {}
    for N in LONG_SOLVE_HORIZONS:
        rec = []
        with prediction_horizon_env(N):
            planner = create_default_container().resolve(se3_mpc.SE3MPCPlanner)
            check(planner.device == dev and planner.config.prediction_horizon == N
                  and planner.config == get_frozen_config().planning.to_se3_config(),
                  f"18c: DART_PREDICTION_HORIZON={N} gave N={planner.config.prediction_horizon} "
                  f"on {planner.device}")
            for o in sc["obstacles"]:
                planner.add_obstacle(o["pos"], o["radius"])
            restore = record_first_solve(rec)
            try:
                torch.cuda.synchronize()
                cuda_mpc.LAUNCHES = 0
                traj = planner.plan_trajectory(state, sc["goal_pos"])
                torch.cuda.synchronize()
                n = cuda_mpc.LAUNCHES
            finally:
                restore()
        launches += n
        check(n == 2, f"18c N={N}: {n} launches of B1 for the DI planner's plan, not 2")
        check(tuple(traj.positions.shape) == (N, 3) and bool(torch.isfinite(traj.positions).all()),
              f"18c N={N}: the plan is not finite ({N}, 3)")
        cfg, prob, u_rec, _, _ = rec[0]
        u0 = se3_mpc.initialize_thrusts(cfg, prob) if u_rec is None else u_rec
        cfg_r = cfg._replace(max_iterations=1, cg_iterations=2, tail_iterations=0)
        one = check_round_scenarios(f"18c N={N} one round",
                                    b1_round_scenarios(cfg_r, prob, u0))
        dpos = plain_gap(rec, f"18c N={N}")
        di[N] = dpos
        print(f"[18c N={N}] ({card}) the DI container's SE3MPCPlanner on {dev} under "
              f"DART_PREDICTION_HORIZON={N} ({cfg.max_iterations} rounds, two-phase, "
              f"{len(sc['obstacles'])} spheres): {n} B1 launches; one CG-2 round of B1 on its "
              f"first problem vs plain: {one}; the plan vs method='torch': positions max "
              f"|diff| {dpos:.3g} m (16a's 1e-3: "
              + ("held" if dpos <= 1e-3 else "not held, float32 chaos at the full budget "
                 "(ROADMAP C.21), not gated") + ")", flush=True)

    ptxas = ptxas_by_steps(_build.build_log)
    if _build.build_log:
        check(sorted(ptxas) == [1, 2, 3, 4, 5] and all(len(v) == 4 for v in ptxas.values()),
              f"18d: ptxas lines for B1's S = {sorted(ptxas)}, not 1-5")
    times = {}
    fused, plain = cuda_mpc.solve_thrusts_fused, cuda_mpc.solve_thrusts_plain
    for N in TIMED_HORIZONS:
        cfg = base._replace(prediction_horizon=N, tail_iterations=0)
        for B in (B_BENCH, 1):
            prob = bench_problem(se3_mpc, cfg, B, 0 if B > 1 else 1, dev)
            u0 = se3_mpc.initialize_thrusts(cfg, prob)
            t_k = cuda_time_ms(lambda: fused(cfg, prob, u0))
            d_k = b1_alone_ms(cfg, prob, u0)
            t_p = cuda_time_ms(lambda: plain(cfg, prob, u0), reps=3, warmup=1)
            bnd, by = b1_bound(cfg, prob)
            times[f"N{N}_B{B}"] = {"ms": t_k, "device_ms": d_k, "plain_ms": t_p, "bound_ms": bnd,
                                   "bound_by": by, "share": bnd / d_k}
            print(f"[18d times] ({card}) phase-1 solve N={N} (S={-(-N // 32)}) B={B}, median "
                  f"CUDA-event ms: kernel {t_k:.4f} (alone {d_k:.4f}, CUDA events around the "
                  f"launch), plain "
                  f"{t_p:.4f}, bound {bnd:.3g} ({by}; share of the kernel alone "
                  f"{bnd / d_k:.3g})", flush=True)
    times["ptxas"] = {f"S{s}": v for s, v in sorted(ptxas.items())}
    times["solves"] = {f"N{N}": v for N, v in solves.items()}
    times["rounds"] = {f"N{N}": v for N, v in rounds.items()}
    print(f"[18 long horizons] ({card}) {time.perf_counter() - t_phase:.1f} s (host clock); "
          f"B1 ptxas by steps a lane (S=5: five or more, counted at run time): "
          + ("; ".join(f"S={s}: {v.get('registers')} registers, {v.get('stack_bytes')} B stack, "
                       f"{v.get('spill_stores')} / {v.get('spill_loads')} B spill stores / loads"
                       for s, v in sorted(ptxas.items())) or "library reused, no build log"),
          flush=True)
    return {"launches": launches, "max_abs_err": max(err_rounds), "times": times,
            "di_max_abs_err_m": max(di.values())}


# phase 18e (ROADMAP C.23): a horizon no phase before it plans at, so its
# cold start's inverse is taken after the fork, not read from the cache; and
# how long that cold start and its solve may take before the smoke fails
FORK_HORIZON = 99
FORK_WATCHDOG_S = 120.0


def fork_cold_start_phase(dev, card: str) -> int:
    """Phase 18e (ROADMAP C.23): with CUDA started in this process,
    ``ProcessControlLoop`` forks it, runs and stops; then the cold start at
    FORK_HORIZON on the bench batch (its Hessian inverse's cache misses once:
    it was not cached) and a two-phase solve through B1, in a thread under a
    watchdog: past FORK_WATCHDOG_S the smoke fails with that thread's stack.
    Returns B1's launches (2)."""
    import threading
    import traceback

    import numpy as np
    import torch

    from dart_planner_tpu_torch.ops import cuda_mpc
    from dart_planner_tpu_torch.planning import se3_mpc
    from dart_planner_tpu_torch.runtime.multiprocess_loop import ProcessControlLoop

    t_phase = time.perf_counter()
    cfg = se3_mpc.SE3MPCConfig(prediction_horizon=FORK_HORIZON)
    prob = bench_problem(se3_mpc, cfg, B_BENCH, FORK_HORIZON, dev)
    host = {"position": np.zeros(3), "velocity": np.ones(3)}
    loop = ProcessControlLoop(_loop_fn, frequency_hz=PROCESS_LOOP_HZ)
    loop.start()
    try:
        loop.send_state(host)
        while loop.get_output(timeout=0.05) is None and time.perf_counter() - t_phase < 10:
            pass
    finally:
        loop.stop()
    check(loop.error is None and not loop.running and loop.last_output == _loop_fn(host),
          f"18e: the process loop gave {loop.last_output}, error {loop.error}, "
          f"running {loop.running}")
    misses = se3_mpc._quadratic_hessian_inverse.cache_info().misses
    out = {}

    def cold_start_and_solve():
        try:
            t0 = time.perf_counter()
            u0 = se3_mpc.initialize_thrusts(cfg, prob)
            torch.cuda.synchronize()
            out["cold_ms"] = 1e3 * (time.perf_counter() - t0)
            cuda_mpc.LAUNCHES = 0
            out["res"] = se3_mpc.solve(cfg, prob, u0, method="auto")
            torch.cuda.synchronize()
            out["launches"] = cuda_mpc.LAUNCHES
        except BaseException as e:  # raised again on the main thread
            out["error"] = e

    worker = threading.Thread(target=cold_start_and_solve, daemon=True)
    worker.start()
    worker.join(FORK_WATCHDOG_S)
    if worker.is_alive():
        stack = "".join(traceback.format_stack(sys._current_frames()[worker.ident]))
        raise SmokeFailure(f"18e: the cold start at N={FORK_HORIZON} and its solve after the "
                           f"fork did not end within {FORK_WATCHDOG_S:g} s (ROADMAP C.23); "
                           f"the thread's stack:\n{stack}")
    if "error" in out:
        raise out["error"]
    check(se3_mpc._quadratic_hessian_inverse.cache_info().misses == misses + 1,
          f"18e: N={FORK_HORIZON}'s Hessian inverse was cached before the fork")
    check(out["launches"] == 2, f"18e: solve() launched B1 {out['launches']} times, not 2")
    check(all(bool(torch.isfinite(x).all()) for x in out["res"]
              if x is not None and x.dtype.is_floating_point), "18e: non-finite solve output")
    print(f"[18e fork, then a cold start] ({card}) ProcessControlLoop forked this process "
          f"after CUDA started, ran and stopped; then the cold start at N={FORK_HORIZON}, not "
          f"cached before (its inverse by Cholesky in torch on the CPU), B={B_BENCH}, in "
          f"{out['cold_ms']:.1f} ms and solve() through B1 ({out['launches']} launches), "
          f"converged {float(out['res'].converged.float().mean()):.4f}, under a "
          f"{FORK_WATCHDOG_S:g} s watchdog; {time.perf_counter() - t_phase:.1f} s (host clock)",
          flush=True)
    return out["launches"]


# phase 18f: B1 past 128 steps, one instantiation for five or more steps a
# lane: one CG-2 round and solve() at the fifth slot's first step (129), a
# full fifth slot (160), eight slots (256) and the smallest horizon whose
# arena spills from shared memory to global scratch (SPILL_HORIZON: 73 floats
# a step, csrc/mpc_solve.cu), at B=64; the two-phase solve at N=160,
# B=4096; times at 160 and SPILL_HORIZON
PAST_128_HORIZONS = (129, 160, 256)
SPILL_HORIZON = 769
PAST_128_B = 64
PAST_128_SOLVE = 160
PAST_128_TIMED = (160, SPILL_HORIZON)


def spill_horizon(lib, K: int) -> int:
    """The smallest N at which ``mpc_scratch_floats`` asks for global
    scratch (a warp's arena and its K spheres past the card's shared
    memory a block), by steps a lane from five on."""
    from dart_planner_tpu_torch.ops import cuda_mpc
    from dart_planner_tpu_torch.planning import se3_mpc

    for steps in range(5, 4096):
        N = 32 * (steps - 1) + 1
        params = cuda_mpc._params(se3_mpc.SE3MPCConfig(prediction_horizon=N), 1, K, True)
        n = lib.mpc_scratch_floats(ctypes.byref(params))
        check(n >= 0, f"mpc_scratch_floats failed: CUDA error {-n}")
        if n > 0:
            return N
    raise SmokeFailure("no horizon spills the arena")


def past_128_phase(dev, card: str) -> dict:
    """Phase 18f: kernel B1 past 128 horizon steps (ROADMAP C.24).

    The smallest horizon whose arena spills to global scratch is read from
    the library (``mpc_scratch_floats``) and must be SPILL_HORIZON, which
    the kernel's header states. At each of PAST_128_HORIZONS and
    SPILL_HORIZON, B=PAST_128_B: one Newton round at CG-2 with every hinge
    on, in both curvature modes, with and without a per-scenario v_cap,
    against the plain loop on the card scenario by scenario with the
    iterates' costs in float64 (:func:`b1_round_scenarios`): every scenario
    within phase 3b's limits (2e-3; 1e-4 relative; improvements 1e-4) but
    at most twice as many, plus one, as the plain loop on the CPU parts from
    itself on the card, and those within 5x the limits or 5x twice the
    plain loop's largest spread (:func:`check_round_scenarios`); and
    ``solve(method="auto")``: 2 launches, finite, no plain path and no
    raise. The two-phase solve at PAST_128_SOLVE, B=4096, against the plain
    path within its own spread (:func:`solve_within_spread`). B1's
    ptxas lines for the run-time instantiation (S=5), and its times at
    PAST_128_TIMED, B=4096 and B=1: with the wrapper, alone (CUDA events
    around the launch), the plain version and the bound."""
    import torch

    from dart_planner_tpu_torch.ops import _build, cuda_mpc
    from dart_planner_tpu_torch.planning import se3_mpc

    t_phase = time.perf_counter()
    base = se3_mpc.SE3MPCConfig(tail_iterations=0)
    lib = cuda_mpc._library()
    spill = spill_horizon(lib, base.max_obstacles)
    check(spill == SPILL_HORIZON,
          f"18f: the arena spills from N={spill}, not SPILL_HORIZON={SPILL_HORIZON}")
    launches, scratch = 0, {}
    err = {False: [], True: []}  # |dx| of the one-round checks, by arena in global scratch
    for N in PAST_128_HORIZONS + (SPILL_HORIZON,):
        cfg = base._replace(prediction_horizon=N)
        prob = bench_problem(se3_mpc, cfg, PAST_128_B, N, dev)
        params = cuda_mpc._params(cfg, PAST_128_B, base.max_obstacles, True)
        scratch[N] = lib.mpc_scratch_floats(ctypes.byref(params))
        check((scratch[N] > 0) == (N >= SPILL_HORIZON),
              f"18f N={N}: {scratch[N]} floats of global scratch")
        u0 = se3_mpc.initialize_thrusts(cfg, prob)
        probv = prob._replace(v_cap=torch.full((PAST_128_B,), 3.0, dtype=torch.float32,
                                               device=dev))
        for label, pr in (("static", prob), ("v_cap=3", probv)):
            for stage, n_gn in (("GN", 1), ("full", 0)):
                cfg_r = cfg._replace(max_iterations=1, cg_iterations=2, gn_warmup_iterations=n_gn)
                tag = f"18f N={N} one round {label} {stage}"
                e = b1_round_scenarios(cfg_r, pr, u0, with_cpu=True)
                c = e["cpu"]
                # phase 3b's limits in every scenario but as many as twice
                # the plain loop's own count apart between the CPU and the
                # card, plus one (a count of none of 64 bounds the rate only
                # to a few in a hundred); those within 5x 3b's limits, or 5x
                # twice the plain loop's largest spread where that is larger
                allowed = 2 * c["n_apart"] + 1
                dx_cap = 5 * max(2e-3, 2 * c["dx"])
                cost_cap = 5 * max(1e-4, 2 * c["c_pl"], 2 * c["di"])
                print(f"[{tag}] the plain loop on the CPU against itself on the card: "
                      f"{c['n_apart']} of {PAST_128_B} scenarios beyond phase 3b's limits, max "
                      f"|dx| {c['dx']:.3g}, exact cost rel {c['c_pl']:.3g}, improvement rel "
                      f"{c['di']:.3g}; so B1 may part {allowed} scenarios, each within "
                      f"{dx_cap:.3g} and {cost_cap:.3g}", flush=True)
                line = check_round_scenarios(tag, e, allowed=allowed, dx_cap=dx_cap,
                                             cost_cap=cost_cap)
                print(f"[{tag}] B={PAST_128_B} CG-2, arena in "
                      f"{'global scratch' if scratch[N] else 'shared memory'}: {line}",
                      flush=True)
                err[scratch[N] > 0].append(e["dx"])
        torch.cuda.synchronize()
        cuda_mpc.LAUNCHES = 0
        res = se3_mpc.solve(se3_mpc.SE3MPCConfig(prediction_horizon=N), prob, method="auto")
        torch.cuda.synchronize()
        n = cuda_mpc.LAUNCHES
        launches += n
        check(n == 2, f"18f N={N}: solve(method='auto') launched B1 {n} times, not 2")
        check(all(bool(torch.isfinite(x).all()) for x in res
                  if x is not None and x.dtype.is_floating_point),
              f"18f N={N}: non-finite solve output")
        print(f"[18f N={N}] solve(method='auto') B={PAST_128_B}: {n} launches of B1, arena "
              f"in {'global scratch' if scratch[N] else 'shared memory'}, converged "
              f"{float(res.converged.float().mean()):.4f}", flush=True)

    cfg = se3_mpc.SE3MPCConfig(prediction_horizon=PAST_128_SOLVE)
    n, solve_rec = solve_within_spread(f"18f N={PAST_128_SOLVE}", cfg,
                                       bench_problem(se3_mpc, cfg, B_BENCH, PAST_128_SOLVE, dev))
    launches += n

    ptxas = ptxas_by_steps(_build.build_log).get(5, {})
    times = {}
    fused, plain = cuda_mpc.solve_thrusts_fused, cuda_mpc.solve_thrusts_plain
    for N in PAST_128_TIMED:
        cfg = base._replace(prediction_horizon=N)
        for B in (B_BENCH, 1):
            prob = bench_problem(se3_mpc, cfg, B, 0 if B > 1 else 1, dev)
            u0 = se3_mpc.initialize_thrusts(cfg, prob)
            reps = 3 if N >= SPILL_HORIZON and B > 1 else 7
            t_k = cuda_time_ms(lambda: fused(cfg, prob, u0), reps=reps, warmup=1)
            d_k = b1_alone_ms(cfg, prob, u0, reps=reps)
            t_p = cuda_time_ms(lambda: plain(cfg, prob, u0), reps=3, warmup=1)
            bnd, by = b1_bound(cfg, prob)
            times[f"N{N}_B{B}"] = {"ms": t_k, "device_ms": d_k, "plain_ms": t_p, "bound_ms": bnd,
                                   "bound_by": by, "share": bnd / d_k}
            print(f"[18f times] ({card}) phase-1 solve N={N} (S={-(-N // 32)}, arena in "
                  f"{'global scratch' if N >= SPILL_HORIZON else 'shared memory'}) B={B}, "
                  f"median CUDA-event ms: kernel {t_k:.4f} (alone {d_k:.4f}, CUDA events around "
                  f"the launch), plain {t_p:.4f}, bound {bnd:.3g} ({by}; share of the kernel "
                  f"alone {bnd / d_k:.3g})", flush=True)
    print(f"[18f past 128] ({card}) {time.perf_counter() - t_phase:.1f} s (host clock); "
          f"{launches} launches of B1 in the solves; one CG-2 round at N = "
          f"{', '.join(map(str, PAST_128_HORIZONS))} (max |dx| {max(err[False]):.3g}) and "
          f"{SPILL_HORIZON} (global scratch, max |dx| {max(err[True]):.3g}); "
          f"the arena spills to global scratch from N={spill} (K={base.max_obstacles}); B1 "
          f"ptxas at five or more steps a lane (S=5): "
          + (f"{ptxas.get('registers')} registers, {ptxas.get('stack_bytes')} B stack, "
             f"{ptxas.get('spill_stores')} / {ptxas.get('spill_loads')} B spill stores / loads"
             if ptxas else "library reused, no build log"), flush=True)
    if _build.build_log:
        check(len(ptxas) == 4, f"18f: no ptxas lines for S=5: {ptxas}")
    return {"launches": launches, "max_abs_err": max(err[False]),
            "max_abs_err_global_scratch": max(err[True]), "spill_horizon": spill,
            "times": {**times, "ptxas_S5": ptxas, "solve_N160": solve_rec}}


# phase 19: the convergence diagnostic's horizons (ROADMAP A.2, C.21)
CONVERGENCE_HORIZONS = (20, 80, 100)
# how far its ship row's converged share at N=20 may be from phase 4's (the
# same batch and solve)
CONVERGENCE_SHIP_TOL = 0.002


def load_script(name: str):
    """``scripts/<name>.py`` loaded by path, as a module (the scripts import
    one another by name: each puts its own directory on ``sys.path``)."""
    import importlib.util

    path = pathlib.Path(__file__).resolve().parent / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def convergence_phase(dev, card: str, conv_phase4: float) -> dict:
    """Phase 19: ``scripts/diag_convergence_torch.py``'s functions on the
    card at each of CONVERGENCE_HORIZONS, B=4096: the ground truth (the
    plain path, 60 rounds at CG-25, no tail), then its rows for the plain
    path and B1 (the uniform budgets, the ship row, the restart row), each
    with its time beside the card. Every cost finite, every share in [0, 1];
    B1's ship row at N=20 within CONVERGENCE_SHIP_TOL of phase 4's converged
    share. Returns B1's launches and the rows."""
    import numpy as np
    import torch

    from dart_planner_tpu_torch.ops import cuda_mpc

    t_phase = time.perf_counter()
    diag = load_script("diag_convergence_torch")
    label = diag.card_label(dev)
    launches, out = 0, {}
    for N in CONVERGENCE_HORIZONS:
        config, prob = diag.make_batch(B_BENCH, horizon=N, device=dev)
        torch.cuda.synchronize()
        cuda_mpc.LAUNCHES = 0
        gt, ms = diag.ground_truth(config, prob)
        check(cuda_mpc.LAUNCHES == 0, f"19 N={N}: the plain ground truth launched B1")
        gt_cost = gt.cost.double().cpu().numpy()
        check(bool(np.isfinite(gt_cost).all()), f"19 N={N}: non-finite ground truth")
        print(f"[19 N={N}] ground truth (60 rounds of CG-25, plain path) converged "
              f"{float(gt.converged.float().mean()):.4f}, median cost {np.median(gt_cost):.3f} "
              f"in {ms:.3f} ms ({label})", flush=True)
        rows = []
        for r in diag.rows(config, prob, gt_cost, ("torch", "cuda"), quick=False):
            check(np.isfinite([r["p95"], r["max"], r["ms"]]).all() and 0 <= r["conv"] <= 1,
                  f"19 N={N}: {r}")
            print(f"[19 N={N}] {diag.format_row(r, label)}", flush=True)
            rows.append(r)
        n = cuda_mpc.LAUNCHES
        launches += n
        check(n >= len(diag.UNIFORM_BUDGETS) + 4, f"19 N={N}: {n} launches of B1 in the rows")
        out[N] = rows
    ship = next(r for r in out[20] if r["method"] == "cuda" and r["budget"].startswith("ship "))
    check(abs(ship["conv"] - conv_phase4) <= CONVERGENCE_SHIP_TOL,
          f"19: the ship row's converged share {ship['conv']:.4f} at N=20 is not within "
          f"{CONVERGENCE_SHIP_TOL} of phase 4's {conv_phase4:.4f}")
    print(f"[19 convergence] ({card}) {time.perf_counter() - t_phase:.1f} s (host clock); "
          f"{launches} launches of B1; the ship row at N=20 converged {ship['conv']:.4f} "
          f"(phase 4: {conv_phase4:.4f})", flush=True)
    return {"launches": launches,  # the rows in JSON: a converged cohort's p95 may be NaN
            "rows": {f"N{N}": [{k: (None if isinstance(v, float) and v != v else v)
                                for k, v in r.items()} for r in rows]
                     for N, rows in out.items()}}


# phase 20: the examples (examples_torch/), each main() with no device at
# the JAX examples' default sizes; the first three-layer plans are re-solved
# on the plain path
EXAMPLE_PARITY_PLANS = 10
# phase 9's quality limits (success >= 0.97, crash <= 0.015) as margins: the
# Monte-Carlo example's kernel path may be below its plain path by no more
EXAMPLE_MC_SUCCESS_MARGIN = 1.0 - 0.97
EXAMPLE_MC_CRASH_MARGIN = 0.015
# the scheduler example's tasks (Hz) and the share of 2 s x rate each run
# count may miss by
EXAMPLE_TASK_RATES = {"control": 200.0, "planning": 25.0, "safety": 50.0}
EXAMPLE_TASK_SLACK = 0.2


def load_example(rel: str):
    """``examples_torch/<rel>.py`` loaded by path, as a module."""
    import importlib.util

    path = pathlib.Path(__file__).resolve().parent / "examples_torch" / f"{rel}.py"
    spec = importlib.util.spec_from_file_location("examples_torch_" + rel.replace("/", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def examples_phase(dev, card: str) -> dict:
    """Phase 20: the nine examples of ``examples_torch/`` on the card, each
    ``main()`` called with no device (the card is its default) at the JAX
    examples' sizes, what it prints dropped for one line here, the launch
    counts of both
    kernels set to 0 just before it and read just after. Launches: 2 of B1
    a solve in batched_solves (its two solves), 2 a shard in
    fleet_sharding, ``num_replans`` of each kernel in monte_carlo_fleet, 2
    of B1 a plan in three_layer_mission and hardware_mission, none in the
    other four. The kernel paths against the plain paths on the same
    inputs: batched_solves at ``method="torch"`` to phase 4's limits
    (converged >= 0.957, thrusts inside their bounds, finite) and 3c's mean
    cost within 5%; monte_carlo_fleet at ``method="torch"`` (the same
    seeded draws) to phase 9's quality limits as margins over the plain
    path, and tracking RMSE below 0.1 m; fleet_sharding at ``method="torch"``
    to phase 11's (converged within 0.002, mean cost within 1e-3); the first
    EXAMPLE_PARITY_PLANS three-layer plans re-solved on the plain path,
    positions within 14c's 1e-3 m. Both missions complete; the demos behave
    as their CPU tests hold them. Returns both kernels' launches and B1's
    per solve."""
    import io

    import torch

    from dart_planner_tpu_torch.ops import cuda_mpc, cuda_rollout
    from dart_planner_tpu_torch.planning import se3_mpc

    t_phase = time.perf_counter()
    total = {"B1": 0, "B2": 0}

    def call(rel, expected=(0, 0), **kw):
        """``main(**kw)`` of the example: its result, launches and host
        seconds. ``expected``: (B1, B2) launches, checked unless None."""
        main = load_example(rel).main
        torch.cuda.synchronize()
        cuda_mpc.LAUNCHES = cuda_rollout.LAUNCHES = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            out = main(**kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        n = (cuda_mpc.LAUNCHES, cuda_rollout.LAUNCHES)
        check(expected is None or n == tuple(expected),
              f"20 {rel}{kw or ''}: launches (B1, B2) {n}, not {expected}")
        total["B1"] += n[0]
        total["B2"] += n[1]
        return out, n, seconds

    def line(name, text, n, seconds):
        print(f"[20 {name}] ({card}) {text}; launches B1 {n[0]}, B2 {n[1]}; {seconds:.1f} s "
              "(host clock)", flush=True)

    # batched_solves: 2048 scenarios, N=20, two-phase; its two solves
    out, n, s = call("intermediate/batched_solves", (4, 0))
    res = out["result"]
    check(all(bool(torch.isfinite(x).all()) for x in res
              if x is not None and x.dtype.is_floating_point), "20 batched_solves: non-finite")
    lb, ub = se3_mpc.SE3MPCConfig().thrust_bounds(device=dev)
    check(bool(((res.thrusts >= lb - 1e-5) & (res.thrusts <= ub + 1e-5)).all()),
          "20 batched_solves: thrusts outside thrust_bounds")
    plain, _, s_p = call("intermediate/batched_solves", method="torch")
    mk, mp = out["mean_cost"], plain["mean_cost"]
    for tag, o in (("kernel", out), ("plain", plain)):
        check(o["converged"] >= 0.957,
              f"20 batched_solves {tag}: converged {o['converged']:.4f} < 0.957")
    check(mk <= 1.05 * mp and mp <= 1.05 * mk,
          f"20 batched_solves: mean cost kernel {mk:.6g} vs plain {mp:.6g} beyond 5%")
    line("batched_solves", f"B={out['batch']}, N=20, two-phase: the timed solve "
         f"{out['ms']:.3f} ms by CUDA events ({out['solves_per_s']:.1f} solves/s), converged "
         f"{out['converged']:.4f}, mean cost {mk:.6g}, worst terminal miss "
         f"{out['worst_miss_m']:.3f} m; method='torch' on the same batch {plain['ms']:.3f} ms, "
         f"converged {plain['converged']:.4f} (>= 0.957 both), mean cost {mp:.6g} (rel "
         f"{abs(mk - mp) / mp:.3g}, <= 5%), {s_p:.1f} s", n, s)
    per_batched_solve = n[0] / 2

    # fleet_sharding: 64 scenarios a card, N=12, 8 rounds, the tail per shard
    fleet = load_example("advanced/fleet_sharding")
    n_dev = fleet.fleet_mesh().size
    out, n, s = call("advanced/fleet_sharding", (2 * n_dev, 0))
    plain, _, s_p = call("advanced/fleet_sharding", method="torch")
    conv_k, conv_p = out["converged"] / out["total"], plain["converged"] / plain["total"]
    rel = abs(out["mean_cost"] - plain["mean_cost"]) / plain["mean_cost"]
    check(out["total"] == plain["total"] == 64 * n_dev, f"20 fleet_sharding: totals {out}")
    check(abs(conv_k - conv_p) <= 0.002,
          f"20 fleet_sharding: converged {conv_k:.4f} vs the plain path's {conv_p:.4f}")
    check(rel <= 1e-3, f"20 fleet_sharding: mean cost vs the plain path's rel {rel:.3g} > 1e-3")
    line("fleet_sharding", f"mesh {out['mesh']}, {out['total']:.0f} scenarios, shards "
         f"{out['shard_shapes']}: converged {out['converged']:.0f}, mean cost "
         f"{out['mean_cost']:.6g}; method='torch': converged {plain['converged']:.0f} (<= 0.002 "
         f"apart), mean cost rel {rel:.3g} (<= 1e-3), {s_p:.1f} s", n, s)

    # monte_carlo_fleet: 32 episodes, N=8, 60 replans of 40 ticks
    replans = load_example("advanced/monte_carlo_fleet").loop_config().num_replans
    out, n, s = call("advanced/monte_carlo_fleet", (replans, replans))
    plain, _, s_p = call("advanced/monte_carlo_fleet", method="torch")
    rk, rp = out["result"], plain["result"]
    same = int(((rk.success == rp.success) & (rk.crashed == rp.crashed)).sum())
    d_rmse = float((rk.tracking_rmse - rp.tracking_rmse).abs().max())
    d_clear = float((rk.min_obstacle_clearance - rp.min_obstacle_clearance).abs().max())
    check(out["success_rate"] >= plain["success_rate"] - EXAMPLE_MC_SUCCESS_MARGIN,
          f"20 monte_carlo_fleet: success {out['success_rate']:.4f} vs the plain path's "
          f"{plain['success_rate']:.4f}")
    check(out["crash_rate"] <= plain["crash_rate"] + EXAMPLE_MC_CRASH_MARGIN,
          f"20 monte_carlo_fleet: crash {out['crash_rate']:.4f} vs the plain path's "
          f"{plain['crash_rate']:.4f}")
    check(out["tracking_rmse_m"] < 0.1 and plain["tracking_rmse_m"] < 0.1,
          f"20 monte_carlo_fleet: tracking RMSE {out['tracking_rmse_m']:.4f} / "
          f"{plain['tracking_rmse_m']:.4f} m")
    line("monte_carlo_fleet", f"{out['episodes']} episodes: success {out['success_rate']:.4f}, "
         f"crash {out['crash_rate']:.4f}, tracking RMSE {out['tracking_rmse_m']:.4f} m, mean "
         f"min clearance {out['mean_min_clearance_m']:.4f} m, final distance p50 "
         f"{out['final_distance_p50_m']:.4f} m; method='torch' on the same draws: success "
         f"{plain['success_rate']:.4f}, crash {plain['crash_rate']:.4f}, RMSE "
         f"{plain['tracking_rmse_m']:.4f} m; {same} of {out['episodes']} episodes with the same "
         f"outcome, max |RMSE diff| {d_rmse:.3g} m, max |clearance diff| {d_clear:.3g} m; "
         f"{s_p:.1f} s", n, s)

    # three_layer_mission: 40 replans at N=12, B=1, two-phase
    rec = []
    restore = record_first_solve(rec, EXAMPLE_PARITY_PLANS)
    try:
        out, n, s = call("advanced/three_layer_mission", (80, 0))
    finally:
        restore()
    plans = out["stats"]["total_plans"]
    check(plans == 40 and len(rec) == EXAMPLE_PARITY_PLANS,
          f"20 three_layer_mission: {plans} plans, {len(rec)} recorded")
    before = cuda_mpc.LAUNCHES
    dpos = [float((pos - se3_mpc.solve(cfg, prob, u0, use_obs, method="torch").positions)
                  .abs().max()) for cfg, prob, u0, use_obs, pos in rec]
    check(cuda_mpc.LAUNCHES == before, "20 three_layer_mission: the plain path launched B1")
    check(max(dpos) <= 1e-3, f"20 three_layer_mission: positions max |kernel - plain| "
          f"{max(dpos):.3g} m > 1e-3")
    p = out["positions"][-1]
    line("three_layer_mission", f"{plans} plans (N=12, B=1), phases {out['phases']}, "
         f"position after the last ({p[0]:.3f}, {p[1]:.3f}, {p[2]:.3f}), mean plan "
         f"{out['stats']['mean_planning_time_ms']:.3f} ms (host clock), emergency plans "
         f"{out['stats']['emergency_plans']}; the first {len(dpos)} plans vs method='torch': "
         f"positions max |diff| {max(dpos):.3g} m (1e-3)", n, s)
    per_three_layer_plan = n[0] / plans

    # hardware_mission: 100 Hz control, 10 Hz planning, tolerance 0.8
    mission = load_example("advanced/hardware_mission")
    check(mission.CONTROL_HZ == 100.0 and mission.PLANNING_HZ == 10.0,
          "20 hardware_mission: not at the JAX example's 100 Hz / 10 Hz")
    out, n, s = call("advanced/hardware_mission", expected=None)
    check(out["mission_complete"] and out["waypoints_reached"] == out["waypoints_total"] == 3
          and out["failsafe_reason"] is None,
          f"20 hardware_mission: complete {out['mission_complete']}, "
          f"{out['waypoints_reached']}/{out['waypoints_total']}, failsafe "
          f"{out['failsafe_reason']}")
    check(out["plans"] > 0 and n == (2 * out["plans"], 0),
          f"20 hardware_mission: launches (B1, B2) {n} for {out['plans']} plans, not 2 a plan")
    line("hardware_mission", f"complete, 3/3 waypoints, {out['plans']} plans, avg plan "
         f"{out['avg_planning_time_ms']:.3f} ms (host clock), {out['commands_sent']} control "
         f"ticks in {out['wall_s']:.1f} s: control rate reached {out['control_hz']:.1f} Hz of "
         f"{mission.CONTROL_HZ:g}, planning failures {out['planning_failures']}", n, s)

    # minimal_takeoff: altitude 3.0, hover 2.0 s
    out, n, s = call("beginner/minimal_takeoff")
    check(out["peak_altitude"] > 2.0 and out["final_altitude"] < 1.5,
          f"20 minimal_takeoff: peak {out['peak_altitude']:.3f}, landed "
          f"{out['final_altitude']:.3f} m")
    line("minimal_takeoff", f"peak {out['peak_altitude']:.3f} m, hover "
         f"{out['hover_altitude']:.3f} m, landed {out['final_altitude']:.3f} m (target "
         f"{out['target_altitude']:.1f})", n, s)

    # state_buffer_demo: DroneStates on the card at 200 Hz
    out, n, s = call("intermediate/state_buffer_demo")
    st = out["stats"]
    check(out["version"] == st["updates"] == st["current_version"] > 10
          and abs(out["timestamp"] - out["past_timestamp"] - 0.05) < 1e-6,
          f"20 state_buffer_demo: {out}")
    line("state_buffer_demo", f"version {out['version']} at t={out['timestamp']:.3f}, 50 ms "
         f"back t={out['past_timestamp']:.3f}", n, s)

    # scheduler_demo: 200/25/50 Hz for 2 s
    out, n, s = call("intermediate/scheduler_demo")
    for name, rate in EXAMPLE_TASK_RATES.items():
        runs = out["counters"][name]
        check(abs(runs - 2.0 * rate) <= EXAMPLE_TASK_SLACK * 2.0 * rate,
              f"20 scheduler_demo: {name} ran {runs} times in 2 s at {rate:g} Hz")
    misses = {k: v["missed_deadlines"] for k, v in out["stats"].items()}
    line("scheduler_demo", f"runs {out['counters']}, missed deadlines {misses}", n, s)

    # heartbeat_demo: interval 100 ms, timeout 300 ms
    out, n, s = call("beginner/heartbeat_demo")
    check(out["emergency_triggered"] and out["fired_after_s"] <= 2.0,
          f"20 heartbeat_demo: {out}")
    line("heartbeat_demo", f"the emergency fired {out['fired_after_s']:.3f} s after the last "
         "heartbeat", n, s)

    print(f"[20 examples] ({card}) {time.perf_counter() - t_phase:.1f} s (host clock); "
          f"launches B1 {total['B1']}, B2 {total['B2']}", flush=True)
    return {"launches": total, "per_solve": {"batched_solve": per_batched_solve,
                                             "three_layer_replan": per_three_layer_plan}}


# phase 21: the port's diagnostics (scripts/*_torch.py, ROADMAP A.5) at the
# JAX scripts' sizes: the bench batch (B=4096, N=20) and the Monte-Carlo
# fleet (2048 episodes), built once for the three Monte-Carlo scripts
DIAG_SCRIPTS = ("measure_scaling_torch", "diag_newton_decrement_torch", "diag_tail_torch",
                "diag_stuck_torch", "diag_fixes_torch", "diag_timeouts_torch",
                "diag_goalclamp_torch", "diag_unknown_torch")
# the C.21 reading: the Newton decrement again at this horizon, not gated
DIAG_LONG_HORIZON = 100
# newton_decrement of B1's thrusts on the card against the CPU's, scenario by
# scenario: relative, plus at least this absolute, or more where the scenario's
# own float32 error is larger: how far the decrement moves when each element
# of its projected gradient moves by DIAG_ND_PG_SPREAD times the CPU's float32
# error in that element (read against float64)
DIAG_ND_RTOL, DIAG_ND_ATOL, DIAG_ND_PG_SPREAD = 1e-4, 1e-9, 8.0


def diagnostics_phase(dev, card: str, conv_phase4: float) -> dict:
    """Phase 21: the eight diagnostics of ``scripts/`` that ROADMAP A.5
    ported, through their row functions on the card, what each prints
    passed through with a ``[21 <script>]`` prefix. The launch counts of
    both kernels are set to 0 before each script and read after: a B1
    solve row launches 2 (every solve row keeps the 8-round tail), a plain
    row none, a fused Monte-Carlo row B1 and B2 once a replan, so each
    Monte-Carlo script launches each kernel once for every replan of its
    rows' configurations. The scaling table's NCCL row of one process at 4096
    scenarios a card exits 0 with a finite rate (its worker is another
    process: its launches are not counted here), and the row of two is
    refused on one card. Every share in [0, 1], every cost and excess
    finite; B1's ``base-12`` row of diag_fixes (the shipping solve on the
    bench batch) within CONVERGENCE_SHIP_TOL of phase 4's converged share;
    ``newton_decrement`` of B1's shipping thrusts on the card within
    DIAG_ND_RTOL plus each scenario's own float32 slack (at least
    DIAG_ND_ATOL) of the same function on the CPU; the
    timeouts' shipping row fused to phase 9's limits, and within
    EXAMPLE_MC_SUCCESS_MARGIN / EXAMPLE_MC_CRASH_MARGIN of the plain path
    on the same fleet and draws. The Newton decrement at N=100 is printed,
    not gated. Returns both kernels' launches."""
    import io
    import math

    import numpy as np
    import torch

    from dart_planner_tpu_torch.common.device import to_host
    from dart_planner_tpu_torch.ops import costs, cuda_mpc, cuda_rollout

    t_phase = time.perf_counter()
    mods = {name: load_script(name) for name in DIAG_SCRIPTS}
    conv = load_script("diag_convergence_torch")
    total = {"B1": 0, "B2": 0}

    def zero():
        torch.cuda.synchronize()
        cuda_mpc.LAUNCHES = cuda_rollout.LAUNCHES = 0

    def counted():
        """The launches since the last zero or read, then zero again."""
        torch.cuda.synchronize()
        n = (cuda_mpc.LAUNCHES, cuda_rollout.LAUNCHES)
        total["B1"] += n[0]
        total["B2"] += n[1]
        cuda_mpc.LAUNCHES = cuda_rollout.LAUNCHES = 0
        return n

    def passed(name, fn, *args, **kw):
        """``fn`` with what it prints passed through, prefixed; its result,
        launches (B1, B2) and host seconds."""
        buf = io.StringIO()
        zero()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                out = fn(*args, **kw)
        finally:
            for ln in buf.getvalue().splitlines():
                print(f"[21 {name}] {ln}", flush=True)
        seconds = time.perf_counter() - t0
        return out, counted(), seconds

    def share(tag, x):
        check(0.0 <= x <= 1.0, f"21 {tag}: share {x} outside [0, 1]")

    def finite(tag, *xs):
        check(all(math.isfinite(x) for x in xs), f"21 {tag}: non-finite {xs}")

    def summary(name, text, n, seconds):
        print(f"[21 {name}] ({card}) {text}; launches B1 {n[0]}, B2 {n[1]}; {seconds:.1f} s "
              "(host clock)", flush=True)

    # -- measure_scaling: NCCL, one card a process; with one card the row of
    # two processes is refused, never run
    rows, _, s = passed("measure_scaling", mods["measure_scaling_torch"].main,
                        ["--per-device", str(B_BENCH), "--max-procs", "2"])
    check(len(rows) == min(2, torch.cuda.device_count()) and rows[0]["processes"] == 1
          and rows[0]["global_batch"] == B_BENCH and math.isfinite(rows[0]["solves_per_s"])
          and rows[0]["solves_per_s"] > 0, f"21 measure_scaling: rows {rows}")
    print(f"[21 measure_scaling] ({card}) NCCL, 1 process, {B_BENCH} scenarios: "
          f"{rows[0]['solves_per_s']:.1f} solves/s (host clock, the worker's own); "
          f"{s:.1f} s (host clock)", flush=True)

    # -- the solver-quality scripts on the bench batch, N=20 ------------------
    nd_mod, tail_mod = mods["diag_newton_decrement_torch"], mods["diag_tail_torch"]
    stuck_mod, fixes_mod = mods["diag_stuck_torch"], mods["diag_fixes_torch"]
    config, prob = conv.make_batch(B_BENCH, device=dev)
    (gt, gt_ms), n, _ = passed("diag_newton_decrement", nd_mod.ground_truth, config, prob)
    check(n == (0, 0), f"21 ground truth: the plain path launched {n}")
    gt_cost = to_host(gt.cost)
    finite("ground truth", *gt_cost.tolist())
    print(f"[21 ground truth] ({card}) 60 rounds of CG-25, the tail kept, plain path, "
          f"B={B_BENCH}: {gt_ms:.3f} ms (CUDA events)", flush=True)

    def nd_rows(cfg, pb, gt_c):
        return list(nd_mod.rows(cfg, pb, gt_c, ("torch", "cuda")))

    for N in (20, DIAG_LONG_HORIZON):
        if N == 20:
            cfg_n, prob_n, gt_n = config, prob, gt_cost
        else:
            cfg_n, prob_n = conv.make_batch(B_BENCH, horizon=N, device=dev)
            gt_n = to_host(passed(f"diag_newton_decrement N={N}", nd_mod.ground_truth,
                                  cfg_n, prob_n)[0][0].cost)
        rows, n, s = passed(f"diag_newton_decrement N={N}", nd_rows, cfg_n, prob_n, gt_n)
        for r in rows:
            print(f"[21 diag_newton_decrement N={N}] {nd_mod.format_row(r, card)}", flush=True)
            share(f"newton N={N}", r["conv"])
            finite(f"newton N={N}", r["p95"], r["max"], r["ms"])
        check(n == (2 * len(nd_mod.BUDGETS), 0),
              f"21 newton N={N}: launches {n}, not 2 a B1 row")
        pick = {(r["method"], r["newton"], r["tol"]): r for r in rows}
        k, p = pick[("cuda", 12, 1e-5)], pick[("torch", 12, 1e-5)]
        summary(f"diag_newton_decrement N={N}", f"12 rounds + tail, decrement < 1e-5: B1 "
                f"{k['conv']:.4f} (excess p95 {k['p95']:.3g}, max {k['max']:.3g}), plain "
                f"{p['conv']:.4f} ({p['p95']:.3g}, {p['max']:.3g})", n, s)

    # the decrement of B1's shipping thrusts, on the card and on the CPU.
    # Near its minimum a float32 gradient is mostly rounding, so each
    # scenario's slack is how far its decrement moves when every element of
    # its projected gradient moves by DIAG_ND_PG_SPREAD times the CPU's own
    # float32 error in that element
    zero()
    res, _ = conv.run(config, prob, "cuda")
    counted()
    u = res.thrusts
    nd_card = to_host(nd_mod.newton_decrement(config, prob, u)[0])
    prob_cpu = costs.Problem(*(None if x is None else x.cpu() for x in prob))
    prob_64 = costs.Problem(*(x if x is None or not x.dtype.is_floating_point else x.double()
                              for x in prob_cpu))
    nd_cpu = to_host(nd_mod.newton_decrement(config, prob_cpu, u.cpu())[0]).astype(np.float64)
    pg, diag_h, cost = (to_host(t).astype(np.float64)
                        for t in nd_mod.decrement_terms(config, prob_cpu, u.cpu()))
    pg_exact = to_host(nd_mod.decrement_terms(config, prob_64, u.cpu().double())[0])
    move = DIAG_ND_PG_SPREAD * np.abs(pg - pg_exact)
    slack = (0.5 * ((2.0 * np.abs(pg) * move + move * move) / diag_h).sum((-1, -2))
             / (1.0 + np.abs(cost)))
    gap = np.abs(nd_card - nd_cpu)
    tol = DIAG_ND_RTOL * np.abs(nd_cpu) + np.maximum(DIAG_ND_ATOL, slack)
    worst = int(np.argmax(gap / tol))
    check(bool((gap <= tol).all()),
          f"21 newton_decrement card vs CPU: {int((gap > tol).sum())} scenarios beyond their "
          f"tolerance, the worst #{worst} by {gap[worst]:.3g} (tolerance {tol[worst]:.3g})")
    small = nd_cpu < 1e-6
    check(bool(small.any()), "21 newton_decrement: no scenario's decrement below 1e-6")
    print(f"[21 diag_newton_decrement] newton_decrement of B1's shipping thrusts, card vs "
          f"CPU: max |diff| {gap.max():.3g}; the worst against its own tolerance #{worst}, "
          f"{gap[worst]:.3g} of {tol[worst]:.3g} ({DIAG_ND_RTOL:g} relative + the larger of "
          f"{DIAG_ND_ATOL:g} and its float32 slack); the slack where the decrement is below "
          f"1e-6 ({int(small.sum())} scenarios): median {np.median(slack[small]):.3g}, "
          f"p99 {np.percentile(slack[small], 99):.3g}, max {slack[small].max():.3g}",
          flush=True)

    def tail_rows():
        out = []
        for method in ("torch", "cuda"):
            out.append(tail_mod.rows(config, prob, gt_cost, method))
            tail_mod.report(out[-1], card)
        return out

    rows, n, s = passed("diag_tail", tail_rows)
    for r in rows:
        share("tail", r["tail"])
        for x in (*r["bound_p50_p90"], r["inside_tail"], r["inside_converged"]):
            check(math.isnan(x) or 0.0 <= x <= 1.0, f"21 tail: share {x}")
        for g in r["grids"]:
            share("tail grid", g["conv_ftol"])
            share("tail grid", g["conv_nd"])
            finite("tail grid", g["p95"], g["ms"])
    check(n == (2 * (1 + len(tail_mod.ROUNDS) + 3), 0), f"21 tail: launches {n}")
    k, p = rows[1], rows[0]
    summary("diag_tail", f"tail at 12 rounds + tail: B1 {k['tail']:.4f}, plain {p['tail']:.4f};"
            f" near-bound |pg|^2 p50/p90 B1 {k['bound_p50_p90'][0]:.3f}/"
            f"{k['bound_p50_p90'][1]:.3f}; hinge-active tail/converged B1 "
            f"{k['inside_tail']:.3f}/{k['inside_converged']:.3f}", n, s)

    (gt0, _), n, _ = passed("diag_stuck", stuck_mod.ground_truth, config, prob)
    check(n == (0, 0), f"21 stuck ground truth: launches {n}")
    gt0_cost = to_host(gt0.cost)

    def stuck_rows():
        out = []
        for method in ("torch", "cuda"):
            out.append(stuck_mod.probe(config, prob, gt0_cost, method))
            stuck_mod.report(out[-1], card)
        return out

    rows, n, s = passed("diag_stuck", stuck_rows)
    check(n == (4, 0), f"21 stuck: launches {n}, not 2 + 2 of B1")
    for r in rows:
        finite("stuck", r["excess"], r["cost"], r["ratio"])
        share("stuck", r["census"]["good"])
    k, p = rows[1], rows[0]
    summary("diag_stuck", f"worst scenario B1 #{k['scenario']} (excess {k['excess']:.4f}, "
            f"converged {k['converged']}, rank {k['rank']}, "
            f"{'in' if k['in_cohort'] else 'not in'} the cohort, jittered good "
            f"{k['census']['good']:.3f}); plain #{p['scenario']} ({p['excess']:.4f}, "
            f"{p['converged']}, rank {p['rank']}, good {p['census']['good']:.3f})", n, s)

    def fixes_rows():
        out = []
        for r in fixes_mod.rows(config, prob, gt_cost, ("torch", "cuda")):
            print(fixes_mod.format_row(r, card))
            out.append(r)
        return out

    rows, n, s = passed("diag_fixes", fixes_rows)
    check(n == (2 * len(fixes_mod.VARIANTS), 0), f"21 fixes: launches {n}")
    for r in rows:
        share("fixes", r["conv"])
        finite("fixes", r["p95"], r["max"], r["ms"])
    base12 = next(r for r in rows if r["method"] == "cuda" and r["variant"] == "base-12")
    check(abs(base12["conv"] - conv_phase4) <= CONVERGENCE_SHIP_TOL,
          f"21 fixes: B1's base-12 converged {base12['conv']:.4f}, not within "
          f"{CONVERGENCE_SHIP_TOL} of phase 4's {conv_phase4:.4f}")
    summary("diag_fixes", f"B1's base-12 converged {base12['conv']:.4f} (phase 4: "
            f"{conv_phase4:.4f}), p95 excess {base12['p95']:.3g}", n, s)

    # -- the Monte-Carlo scripts on one fleet and its draws -------------------
    to_mod, gc_mod = mods["diag_timeouts_torch"], mods["diag_goalclamp_torch"]
    un_mod = mods["diag_unknown_torch"]
    t0 = time.perf_counter()
    fleet = to_mod.build_fleet(B_MC, 0, dev)
    torch.cuda.synchronize()
    print(f"[21 fleet] ({card}) {B_MC} episodes, worlds perceived, wind and "
          f"{fleet.noise.shape[0]} noise blocks drawn once: {time.perf_counter() - t0:.1f} s "
          "(host clock)", flush=True)

    def replans(configs):
        """B1's and B2's launches of the fused rows ``configs``: one each a
        replan."""
        n = sum(cfg.num_replans for cfg in configs)
        return (n, n)

    base = to_mod.base_config()
    out, n, s = passed("diag_timeouts", to_mod.rows, fleet, "auto", label=card)
    want = replans(cfg for _, cfg, _ in to_mod.row_configs(base))
    check(n == want, f"21 timeouts: launches {n}, not {want}")
    for tag, r in out["rows"].items():
        for key in ("success", "crash", "timeout"):
            share("timeouts", r[key])
        for name_, x in zip(r["result"]._fields, r["result"]):
            if x.dtype.is_floating_point:
                check(bool(torch.isfinite(x).all()), f"21 timeouts {tag}: non-finite {name_}")
    ship = out["rows"]["6s shipping (cap 2.0)"]
    check(ship["success"] >= 0.97 and ship["crash"] <= 0.015,
          f"21 timeouts: the shipping row's success {ship['success']:.4f} (>= 0.97), "
          f"crash {ship['crash']:.4f} (<= 0.015)")
    (plain, plain_ms), n_p, s_p = passed("diag_timeouts plain", to_mod.fly, base, fleet,
                                         "torch")
    check(n_p == (0, 0), f"21 timeouts: the plain row launched {n_p}")
    ps = float(plain.success.float().mean())
    pc = float(plain.crashed.float().mean())
    check(ship["success"] >= ps - EXAMPLE_MC_SUCCESS_MARGIN
          and ship["crash"] <= pc + EXAMPLE_MC_CRASH_MARGIN,
          f"21 timeouts: the fused shipping row (success {ship['success']:.4f}, crash "
          f"{ship['crash']:.4f}) vs the plain path's ({ps:.4f}, {pc:.4f})")
    summary("diag_timeouts", f"6 s shipping success {ship['success']:.4f}, crash "
            f"{ship['crash']:.4f}, timeout {ship['timeout']:.4f} in {ship['ms']:.3f} ms "
            f"(CUDA events); method='torch' on the same draws success {ps:.4f}, crash "
            f"{pc:.4f} in {plain_ms:.3f} ms ({s_p:.1f} s)", n, s)

    rows, n, s = passed("diag_goalclamp", gc_mod.rows, fleet, "auto", card)
    want = replans(cfg for _, _, cfg in gc_mod.row_configs())
    check(n == want, f"21 goalclamp: launches {n}, not {want}")
    for r in rows:
        for key in ("success", "crash", "timeout"):
            share("goalclamp", r[key])
        finite("goalclamp", r["ms"])
    summary("diag_goalclamp", f"{len(rows)} (clamp, floor) rows", n, s)

    base, caps = un_mod.base_config(), (0.0, 5.0, 4.0, 3.0)
    out, n, s = passed("diag_unknown", un_mod.rows, fleet, caps, method="auto", base=base,
                       label=card)
    # the cap rows and the uncapped check, which flies ``base`` once more
    want = replans([cfg for _, cfg, _ in un_mod.row_configs(base, caps)] + [base])
    check(n == want, f"21 unknown: launches {n}, not {want}")
    for r in out["rows"]:
        share("unknown", r["success"])
        share("unknown", r["crash"])
        finite("unknown", r["rmse"], r["clearance"], r["final_p95"])
    summary("diag_unknown", f"caps {[r['cap'] for r in out['rows']]} and the uncapped "
            "check", n, s)
    print(f"[21 diagnostics] ({card}) {time.perf_counter() - t_phase:.1f} s (host clock); "
          f"launches B1 {total['B1']}, B2 {total['B2']}", flush=True)
    return total


BENCH_TIMEOUT_S = 600.0
# the launches of (B1, B2) in each section of bench_torch.py, reckoned from
# the code: a two-phase solve launches B1 twice (phase 1 and the tail), a
# phase-1 solve once, a fast-path replan is one two-phase solve at B=1, and a
# Monte-Carlo run launches each kernel once a replan (60 replans)
BENCH_LAUNCHES = {
    "launches_per_solve": {"B1": 2.0, "B2": 0.0},
    "phase1_launches_per_solve": {"B1": 1.0, "B2": 0.0},
    "single_launches_per_solve": {"B1": 2.0, "B2": 0.0},
    "fastpath_launches_per_replan": {"B1": 2.0, "B2": 0.0},
    "fleet_launches_per_solve": {"B1": 2.0, "B2": 0.0},
    "mc_launches_per_run": {"B1": 60.0, "B2": 60.0},
}
# and over the whole run, each section's warm-ups included: throughput (1 +
# 3 x 30) x (2 + 1), single (1 + 3 x 100) x 2, fast path (1 + 150) x 2,
# fleet (1 + 2 x 6) x 2, Monte-Carlo (1 + 3) x 60 of each kernel
BENCH_TOTAL = {"B1": 91 * 3 + 301 * 2 + 151 * 2 + 13 * 2 + 4 * 60, "B2": 4 * 60}


def bench_phase(card: str) -> dict:
    """Phase 22: the port's benchmark as a user runs it, ``python -m
    dart_planner_tpu_torch.apps.cli bench``, in a process of its own at its
    full sizes (bench.py's five sections: 4096 scenarios two-phase and phase
    1, B=1, the fast path into the native 400 Hz loop, the fleet of 131,072,
    the 2048-episode Monte-Carlo). Its last JSON line must carry all five
    sections, no ``section_errors``, ``truncated`` false, the latency gate
    passed on ``RealTimeControlLoop``, the Monte-Carlo within phase 9's
    limits, every section's launches of both kernels as BENCH_LAUNCHES and
    the whole run's as BENCH_TOTAL, finite positive rates, and this card's
    label; the process exits 0. Returns the run's launches of B1 and B2."""
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "dart_planner_tpu_torch.apps.cli", "bench"],
            cwd=pathlib.Path(__file__).resolve().parent, capture_output=True, text=True,
            timeout=BENCH_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise SmokeFailure(f"22 bench: no end in {BENCH_TIMEOUT_S} s") from e
    seconds = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    check(bool(lines), f"22 bench: rc {proc.returncode}, no record; {proc.stderr[-2000:]}")
    rec = json.loads(lines[-1])
    print(f"[22 bench] record {lines[-1]}", flush=True)
    check(proc.returncode == 0, f"22 bench: rc {proc.returncode}; {proc.stderr[-2000:]}")
    check(rec["sections"] == ["throughput", "single", "fastpath", "fleet", "mc"],
          f"22 bench: sections {rec['sections']}")
    check("section_errors" not in rec and rec["truncated"] is False,
          f"22 bench: errors {rec.get('section_errors')}, truncated {rec['truncated']}")
    check(rec["latency_gate_ok"] is True and rec["rt_loop"] == "RealTimeControlLoop",
          f"22 bench: latency gate {rec['latency_gate_ok']} on {rec['rt_loop']}")
    check(rec["mc_success_rate"] >= 0.97 and rec["mc_crash_rate"] <= 0.015
          and rec["tracking_rmse_m"] < 0.1,
          f"22 bench: Monte-Carlo success {rec['mc_success_rate']}, crash "
          f"{rec['mc_crash_rate']}, RMSE {rec['tracking_rmse_m']} m")
    for key, want in BENCH_LAUNCHES.items():
        check(rec[key] == want, f"22 bench: {key} {rec[key]}, not {want}")
    check(rec["launches"] == BENCH_TOTAL,
          f"22 bench: launches {rec['launches']}, not {BENCH_TOTAL}")
    for key in ("value", "phase1_solves_per_s", "fleet_131072_solves_per_s",
                "closed_loop_episodes_per_s", "single_solve_device_ms",
                "planner_to_actuator_p95_ms"):
        check(math.isfinite(rec[key]) and rec[key] > 0, f"22 bench: {key} {rec[key]}")
    check(rec["card"] == card and rec["device"] == "cuda",
          f"22 bench: card {rec['card']!r} on {rec['device']}")
    print(f"[22 bench] ({card}) two-phase {rec['value']} solves/s at 4096 "
          f"({rec['batch_step_ms']} ms a solve), phase 1 {rec['phase1_solves_per_s']}; "
          f"B=1 {rec['single_solve_device_ms']} ms; fleet of 131,072 "
          f"{rec['fleet_131072_solves_per_s']} solves/s (CUDA events); fast path p95 "
          f"planning {rec['planning_host_p95_ms']} ms, tick {rec['control_tick_p95_ms']} "
          f"ms, planner-to-actuator {rec['planner_to_actuator_p95_ms']} ms (host clock, "
          f"{rec['rt_loop']}); Monte-Carlo {rec['closed_loop_episodes_per_s']} episodes/s, "
          f"success {rec['mc_success_rate']}, crash {rec['mc_crash_rate']}, RMSE "
          f"{rec['tracking_rmse_m']} m; launches B1 {rec['launches']['B1']}, B2 "
          f"{rec['launches']['B2']}; the bench's own {rec['elapsed_s']} s, "
          f"{seconds:.1f} s with its process (host clock)", flush=True)
    return rec["launches"]


def run(baseline_source=None) -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: no GPU to test")

    try:
        from dart_planner_tpu_torch.ops import _build, cuda_mpc, cuda_rollout
    except ImportError as e:
        raise SmokeFailure(f"the port does not import ({e}): run this script from the "
                           "root of a checkout of the repository") from e

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
             if "entry function" in ln or "registers" in ln or "spill" in ln]
    print(f"[2 build] {_build.library_path().name} in {built:.1f} s "
          f"(nvcc {_build.build_seconds:.1f} s); ptxas: {' | '.join(ptxas)}",
          flush=True)
    baseline = None
    if baseline_source is not None:
        t0 = time.perf_counter()
        baseline = load_baseline(pathlib.Path(baseline_source))
        print(f"[2 build] baseline {baseline_source} in {time.perf_counter() - t0:.1f} s",
              flush=True)

    # -- 8. kernel B2 vs plain ----------------------------------------------
    err_b2 = tick_block_phase(dev)
    # -- 9. main path of this slice: the closed-loop Monte-Carlo ------------
    mc = closed_loop_phase(dev)
    # -- 3e. kernel B1 at K=11 on the fleet's first replan ------------------
    err_k11 = b1_k11_phase(mc["first"])
    # -- 3f. kernel B1 in the small convex regime, round by round ----------
    convex_tie_phase(dev)
    # -- 3-7. kernel B1 at the solve bench, the first slice's main path -----
    b1 = solver_phases(dev, card, mc["first"])
    # -- 10. times of the closed-loop slice -----------------------------------
    t_b2 = closed_loop_times(dev, card, baseline)
    # -- 11-13. the fleet, the scenario library and the resumable sweep ------
    fleet = fleet_phase(dev, card)
    scen = scenarios_phase(dev, card)
    sweep = sweep_phase(dev, card)
    fig_launches = scen["launches"]["figure8"]
    # -- 14. the three-layer mission stack: hardware mission, three-layer loop
    mission = mission_phase(dev, card)
    layers = three_layer_phase(dev, card, mission["per_plan"])
    dpos_mission = vehicle_parity_phase(dev, card, mission)
    # -- 15. the edge<->cloud deployment and the edge's onboard fallback ------
    deploy = deployment_phase(dev, card)
    onboard = onboard_phase(dev, card)
    # -- 16. the front door: the config's planner and the web demo ------------
    t16 = time.perf_counter()
    di = di_planner_phase(dev, card)
    demo = web_demo_phase(dev, card)
    print(f"[16 front door] ({card}) {time.perf_counter() - t16:.1f} s (host clock)", flush=True)
    # -- 17. the MAVLink mission, the secure channel, AirSim, the process loop
    t17 = time.perf_counter()
    mav = mavlink_phase(dev, card)
    secure = secure_phase(dev, card)
    airsim_phase(dev, card)
    process_loop_phase(dev, card, secure["vehicle"])
    print(f"[17 adapters] ({card}) {time.perf_counter() - t17:.1f} s (host clock)", flush=True)
    # -- 18. kernel B1 past 64 horizon steps, after 17e's fork: the order in
    # which the cold start's inverse once hung (ROADMAP C.23); 18d and 18f
    # time B1 by CUDA events, which late phases do not lose
    lh = long_horizon_phase(dev, card)
    fork_launches = fork_cold_start_phase(dev, card)
    past = past_128_phase(dev, card)
    # -- 19. the convergence diagnostic at N = 20, 80 and 100 ------------------
    conv = convergence_phase(dev, card, b1["converged"])
    # -- 20. the examples (examples_torch/) on the card ------------------------
    ex = examples_phase(dev, card)
    # -- 21. the diagnostics (scripts/*_torch.py) on the card -----------------
    diag = diagnostics_phase(dev, card, b1["converged"])
    # -- 22. the port's benchmark (bench_torch.py) through the CLI -------------
    bench = bench_phase(card)

    replans = mc_config().num_replans
    return {
        "kernels": [
            {
                "name": "mpc_solve (B1, fused projected-Newton solve)",
                "route": "cuda",
                "source": cuda_mpc.SOURCE,
                "replaces": cuda_mpc.REPLACES,
                "scope": (f"any N >= 1: one instantiation each for 1-4 steps a lane (N <= "
                          f"128), one for five or more with the step count read at run time, "
                          f"its arena in shared memory up to N={past['spill_horizon'] - 1} "
                          f"and in global scratch from N={past['spill_horizon']} (K=8)"),
                "launches": mc["launches"]["B1"],
                "launches_by_path": {"closed_loop": mc["launches"]["B1"],
                                     "solve": b1["launches"], "fleet": fleet["launches"],
                                     "figure8": fig_launches["B1"],
                                     "sweep": sweep["launches"]["B1"],
                                     "mission": mission["launches"],
                                     "three_layer": layers["launches"],
                                     ("cli_cloud" if deploy["via_cli"] else "cloud"):
                                         deploy["launches"],
                                     "onboard": onboard["launches"],
                                     "di_planner": di["launches"],
                                     "web_demo": demo["launches"],
                                     "mavlink_mission": mav["launches"],
                                     "secure_interface": secure["launches"],
                                     "long_horizon": lh["launches"],
                                     "fork_cold_start": fork_launches,
                                     "past_128": past["launches"],
                                     "convergence": conv["launches"],
                                     "examples": ex["launches"]["B1"],
                                     "diagnostics": diag["B1"],
                                     "bench": bench["B1"]},
                "launches_per_solve": {"two_phase_solve": b1["launches"],
                                       "closed_loop_replan": mc["launches"]["B1"] / replans,
                                       "mission_replan": mission["per_plan"],
                                       "cloud_replan": deploy["launches"] / deploy["plans"],
                                       "onboard_replan": onboard["per_replan"],
                                       "di_planner_plan": di["per_plan"],
                                       "web_demo_replan": demo["per_plan"],
                                       "mavlink_replan": mav["per_plan"],
                                       "secure_plan": secure["per_plan"],
                                       "examples_batched_solve":
                                           ex["per_solve"]["batched_solve"],
                                       "examples_three_layer_replan":
                                           ex["per_solve"]["three_layer_replan"]},
                "mission_max_abs_err_m": dpos_mission,
                "cloud_max_abs_err_m": deploy["parity_m"],
                "onboard_max_abs_err_m": onboard["parity_m"],
                "di_planner_max_abs_err_m": di["parity_m"],
                "web_demo_max_abs_err_m": demo["parity_m"],
                "mavlink_max_abs_err_m": mav["parity_m"],
                "secure_interface_max_abs_err_m": secure["parity_m"],
                "long_horizon_di_max_abs_err_m": lh["di_max_abs_err_m"],
                # one CG-2 round at N=769, the arena in global scratch, where
                # the plain loop on the CPU parts from itself on the card by
                # as much: apart from the headline
                "global_scratch_max_abs_err": past["max_abs_err_global_scratch"],
                "max_abs_err": max(b1["max_abs_err"], err_k11, fleet["max_abs_err"],
                                   lh["max_abs_err"], past["max_abs_err"]),
                "ms": b1["ms"],
                "device_ms": b1["device_ms"],
                "plain_ms": b1["plain_ms"],
                "bound_ms": b1["bound_ms"],
                "bound_by": b1["bound_by"],
                "library_ms": None,
                "times": {**b1["times"], "fleet_131072": {
                    k: fleet[k] for k in ("ms", "ms_without_stats", "device_ms",
                                          "bound_ms", "bound_by", "peak_bytes")},
                          "long_horizon": lh["times"], "past_128": past["times"]},
                "convergence": conv["rows"],
            },
            {
                "name": "tick_block (B2, closed-loop control and physics ticks)",
                "route": "cuda",
                "source": cuda_rollout.SOURCE,
                "replaces": cuda_rollout.REPLACES,
                "launches": mc["launches"]["B2"],
                "launches_by_path": {"closed_loop": mc["launches"]["B2"],
                                     "figure8": fig_launches["B2"],
                                     "sweep": sweep["launches"]["B2"],
                                     "examples": ex["launches"]["B2"],
                                     "diagnostics": diag["B2"],
                                     "bench": bench["B2"]},
                "launches_per_solve": {"closed_loop_replan": mc["launches"]["B2"] / replans},
                "max_abs_err": max(err_b2, scen["err_b2"]),
                "ms": t_b2["ms"],
                "device_ms": t_b2["device_ms"],
                "plain_ms": t_b2["plain_ms"],
                "bound_ms": t_b2["bound_ms"],
                "bound_by": t_b2["bound_by"],
                "sm_mhz": t_b2["sm_mhz"],
                "library_ms": None,
            },
        ]
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", help="an earlier csrc/tick_block.cu with the same "
                        "C interface, to time turn by turn beside kernel B2 (phase 10)")
    args = parser.parse_args()
    t0 = time.perf_counter()
    try:
        record = run(args.baseline)
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    import torch

    print(f"[total] {time.perf_counter() - t0:.1f} s (host clock, the build included)",
          flush=True)
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
