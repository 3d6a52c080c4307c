"""Benchmark scenario library (PyTorch counterpart of
:mod:`dart_planner_tpu.sim.scenarios`): the five BASELINE configurations.

1. single-drone hover-to-waypoint solve at N=20  -> :func:`hover_to_waypoint`
2. obstacle avoidance with mapper collision costs -> :func:`mapper_navigation`
3. aggressive figure-8 tracking at 50 Hz replan   -> :func:`figure8_tracking`
4. 4096-scenario Monte-Carlo batch                -> sim.monte_carlo
   (resumable: sim.checkpoint.run_sweep)
5. sharded scenario fleet                         -> parallel.solve_fleet

Each runs on the card unless ``device="cpu"`` is passed; on the card every
solve is kernel B1 and figure-8's control ticks are kernel B2.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from dart_planner_tpu_torch.common import frames
from dart_planner_tpu_torch.common.device import resolve_device
from dart_planner_tpu_torch.common.types import DroneState
from dart_planner_tpu_torch.control import geometric
from dart_planner_tpu_torch.ops import costs, cuda_mpc, cuda_rollout
from dart_planner_tpu_torch.perception.mapper import GeometricMapper
from dart_planner_tpu_torch.planning import se3_mpc
from dart_planner_tpu_torch.sim import closed_loop
from dart_planner_tpu_torch.sim import physics as phys

Tensor = torch.Tensor


def _single_phase(config: se3_mpc.SE3MPCConfig, prob: costs.Problem) -> se3_mpc.SolveResult:
    """The JAX package's ``solve_se3_mpc``: one fixed-budget solve, no tail
    or restart; kernel B1 on the card, the plain loop on the CPU."""
    return se3_mpc.solve(config._replace(tail_iterations=0, restart_iterations=0), prob)


def hover_to_waypoint(
    config: se3_mpc.SE3MPCConfig = se3_mpc.SE3MPCConfig(),
    start=(0.0, 0.0, 2.0),
    goal=(5.0, 0.0, 3.0),
    device=None,
) -> se3_mpc.SolveResult:
    """BASELINE config 1: one solve, scipy-reference-comparable."""
    prob = se3_mpc.make_problem(
        start, (0.0, 0.0, 0.0), goal, config=config, device=resolve_device(device)
    )
    return _single_phase(config, prob)


def mapper_navigation(
    config: se3_mpc.SE3MPCConfig = se3_mpc.SE3MPCConfig(),
    start=(0.0, 0.0, 2.0),
    goal=(10.0, 0.0, 3.0),
    scene=(((5.0, 0.5, 2.5), 0.8), ((7.5, -1.0, 3.0), 0.6)),
    device=None,
):
    """BASELINE config 2: lidar -> mapper -> extracted obstacles -> solve.
    Returns ``(result, mapper)``."""
    mapper = GeometricMapper(device=device)
    true_obs = np.asarray([[*c, r] for c, r in scene], np.float32)
    pos = np.asarray(start, np.float32)
    for _ in range(5):
        o, d, t = mapper.simulate_lidar_scan(pos, true_obs)
        mapper.update_map(o, d, t)
    obs, mask = mapper.extract_obstacles(pos, config.max_obstacles)
    prob = se3_mpc.make_problem(
        pos, np.zeros(3, np.float32), np.asarray(goal, np.float32),
        obstacles=obs[mask], config=config, device=mapper.device,
    )
    return _single_phase(config, prob), mapper


class Figure8Result(NamedTuple):
    tracking_rmse: Tensor  # ()
    max_error: Tensor  # ()
    positions: Tensor  # (num_replans, 3)
    references: Tensor  # (num_replans, 3)


def _fig8_ref(t: Tensor, a: float, b: float, omega: float, z0: float):
    """Lemniscate-of-Gerono reference with velocity/acceleration."""
    x = a * torch.sin(omega * t)
    y = b * torch.sin(2 * omega * t)
    pos = torch.stack([x, y, torch.full_like(t, z0)], dim=-1)
    vx = a * omega * torch.cos(omega * t)
    vy = 2 * b * omega * torch.cos(2 * omega * t)
    vel = torch.stack([vx, vy, torch.zeros_like(t)], dim=-1)
    ax = -a * omega**2 * torch.sin(omega * t)
    ay = -4 * b * omega**2 * torch.sin(2 * omega * t)
    acc = torch.stack([ax, ay, torch.zeros_like(t)], dim=-1)
    return pos, vel, acc


def figure8_tracking(
    mpc: se3_mpc.SE3MPCConfig = se3_mpc.SE3MPCConfig(),
    physics: phys.PhysicsConfig = phys.PhysicsConfig(max_thrust=25.0),
    control: geometric.GeometricConfig = geometric.GeometricConfig(
        mass=1.5, max_thrust=25.0
    ),
    a: float = 4.0,
    b: float = 2.0,
    period_s: float = 12.0,
    z0: float = 3.0,
    num_replans: int = 600,  # 50 Hz replan for 12 s (one full figure)
    sub_ticks: int = 8,  # 400 Hz control
    device=None,
    method: str = "auto",
) -> Figure8Result:
    """BASELINE config 3: aggressive figure-8 tracking with 50 Hz replans.

    Each replan solves the MPC (single phase, no obstacles) toward per-step
    goals along the lemniscate one horizon ahead, warm started from the last
    plan shifted a step; the controller then tracks the plan for
    ``sub_ticks`` control ticks against rigid-body physics. Returns
    closed-loop tracking statistics against the analytic reference.

    ``method`` as :func:`~.closed_loop.simulate_episode`'s: ``"fused"``
    runs each replan as one launch of kernel B1
    (:func:`~..ops.cuda_mpc.solve_thrusts_fused`) and one of kernel B2
    (:func:`~..ops.cuda_rollout.run_tick_block`, the closed loop's tick:
    the same setpoint interpolation, ``compute_control`` and
    ``rigid_body_step``) on a card, and their plain versions on the CPU;
    outside B2's scope it raises on a card (:func:`~.closed_loop.
    uses_tick_block`). ``"torch"`` is the plain solve and the per-tick
    loop; ``"auto"`` is ``"fused"`` on a card, ``"torch"`` on the CPU. The
    lemniscate, the plan and the warm start stay on the device: the loop
    makes no host round trip."""
    device = resolve_device(device)
    kw = dict(dtype=torch.float32, device=device)
    omega = 2 * math.pi / period_s
    replan_dt = 0.02 * sub_ticks / 8  # 0.02 s at defaults -> 50 Hz
    control_dt = replan_dt / sub_ticks
    loop = closed_loop.ClosedLoopConfig(
        mpc=mpc, physics=physics, control=control, control_dt=control_dt,
        physics_substeps=1, substeps_per_plan=sub_ticks, num_replans=num_replans,
    )
    method = closed_loop.resolve_method(method, device)
    fused = closed_loop.uses_tick_block(loop, method, (1,), device)
    N = mpc.prediction_horizon

    # every replan's per-step goals and the reference after its block, in
    # float32 as the JAX package computes them
    t = torch.arange(num_replans, **kw) * replan_dt
    plan_offsets = mpc.dt * (1.0 + torch.arange(N, **kw))
    goals, _, _ = _fig8_ref(t[:, None] + plan_offsets, a, b, omega, z0)
    refs, _, _ = _fig8_ref(t + replan_dt, a, b, omega, z0)

    p0, v0, _ = _fig8_ref(torch.zeros((1,), **kw), a, b, omega, z0)
    rb = phys.RigidBodyState.from_drone_state(
        DroneState.zeros((1,), device=device).replace(position=p0, velocity=v0)
    )
    ctrl = geometric.ControllerState.zeros(control, (1,), device=device)
    u = torch.tensor([0.0, 0.0, mpc.hover_thrust], **kw).expand(1, N, 3)
    no_obstacles = torch.zeros((1, 1, 4), **kw)
    no_mask = torch.zeros((1, 1), dtype=torch.bool, device=device)
    gvec = frames.gravity_vector(frames.WorldFrame.ENU, mpc.gravity, device=device)
    zeros3 = torch.zeros((1, 3), **kw)
    if fused:
        S = cuda_rollout.pack_state(rb, ctrl)
        goal_wind = torch.zeros((cuda_rollout.ACC_ROWS, 1), **kw)
    clock = torch.zeros((1,), **kw)

    positions = []
    for k in range(num_replans):
        p_now, v_now = (S[0:3].T, S[3:6].T) if fused else (rb.position, rb.velocity)
        prob = costs.Problem(p0=p_now, v0=v_now, goal=goals[k][None],
                             obstacles=no_obstacles, obstacle_mask=no_mask)
        u_start = se3_mpc.shift_warm_start(mpc, u)
        if fused:
            u, _, pos, vel, _ = cuda_mpc.solve_thrusts_fused(
                mpc, prob, u_start, use_obstacles=False
            )
            spp, spv, spa = cuda_rollout.setpoints_from_plan(
                pos, vel, u / mpc.mass + gvec, sub_ticks, control_dt, mpc.dt
            )
            S, _ = cuda_rollout.run_tick_block(
                control, physics, control_dt, sub_ticks, 1, S, spp, spv, spa, goal_wind
            )
            positions.append(S[0:3, 0])
        else:
            res = se3_mpc.solve_se3_mpc(mpc, prob, u_start, use_obstacles=False,
                                        with_grad=False)
            u = res.thrusts
            rb, ctrl, clock, _ = closed_loop._tick_loop(
                loop, rb, ctrl, clock, res, zeros3, zeros3, None, None
            )
            positions.append(rb.position[0])

    positions = torch.stack(positions)
    errs = torch.linalg.vector_norm(positions - refs, dim=-1)
    return Figure8Result(
        tracking_rmse=torch.sqrt(torch.mean(errs**2)),
        max_error=errs.max(),
        positions=positions,
        references=refs,
    )
