"""Closed-loop plan -> control -> physics episodes (PyTorch counterpart of
:mod:`dart_planner_tpu.sim.closed_loop`).

An episode is a loop over replan blocks: an SE(3) MPC solve, then
``substeps_per_plan`` ticks of the geometric controller driving the
rigid-body plant. The Monte-Carlo fleet is one batched episode over
randomized starts, winds and obstacle fields.

``method`` picks the path of every block:

- ``"torch"``: the plain solve and a per-tick loop of
  :func:`~dart_planner_tpu_torch.control.geometric.compute_control` and
  :func:`~dart_planner_tpu_torch.sim.physics.rigid_body_step` (the JAX
  package's scan path, ``"xla"``);
- ``"fused"``: ``solve(method="auto")`` (kernel B1 on CUDA tensors) and
  the packed tick block :func:`~dart_planner_tpu_torch.ops.cuda_rollout.
  run_tick_block` (kernel B2 on CUDA tensors) for every configuration the
  JAX package's closed loop takes: either anti-windup method, either yaw
  convention, any number of ticks a replan (B2 splits a block past its
  shared memory into launches), any batch shape (flattened to one axis for
  the whole episode and restored in the result). On CPU tensors both
  wrappers run their plain versions, so this path is testable on the CPU;
- ``"auto"``: ``"fused"`` on CUDA tensors, ``"torch"`` on CPU tensors.

Randomness comes from a ``torch.Generator`` on the CPU (a CPU and a GPU run
see the same draws); wind and sensor noise may also be passed in drawn.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from dart_planner_tpu_torch.common.device import default_device
from dart_planner_tpu_torch.common.metrics import span
from dart_planner_tpu_torch.common.types import DroneState
from dart_planner_tpu_torch.control import geometric
from dart_planner_tpu_torch.ops import costs, cuda_rollout
from dart_planner_tpu_torch.ops.device_constants import vector
from dart_planner_tpu_torch.perception.mapper import unit_linspace
from dart_planner_tpu_torch.planning import se3_mpc
from dart_planner_tpu_torch.sim import physics as phys

Tensor = torch.Tensor

METHODS = ("auto", "torch", "fused")


class ClosedLoopConfig(NamedTuple):
    """Static episode configuration: the JAX package's fields and defaults
    (see its docstring for the measured rationale of each)."""

    # tail refinement off in-loop; goal-adjacent margin clamp on
    mpc: se3_mpc.SE3MPCConfig = se3_mpc.SE3MPCConfig(
        tail_iterations=0, goal_margin_clamp=0.5
    )
    # thrust ceilings aligned with the planner's 25 N
    physics: phys.PhysicsConfig = phys.PhysicsConfig(max_thrust=25.0)
    control: geometric.GeometricConfig = geometric.GeometricConfig(
        mass=1.5, max_thrust=25.0
    )
    control_dt: float = 0.0025  # 400 Hz control
    physics_substeps: int = 1  # integration substeps per control tick
    substeps_per_plan: int = 40  # -> replans at 10 Hz
    num_replans: int = 60  # 6 s episode
    goal_tolerance: float = 1.0  # m
    sensor_noise_std: float = 0.0  # m / m s^-1 position/velocity noise
    wind_mean: float = 0.0
    wind_std: float = 0.0
    min_altitude: float = 0.05  # below this = crash
    # in-flight proximity sensing: TRUE spheres whose surface is within
    # this range join the planner's obstacle set at each replan (0 = off)
    sense_radius: float = 0.0
    # unknown-space speed cap near unobserved corridor samples (0 = off)
    unknown_speed_cap: float = 0.0
    unknown_coverage: float = 0.6  # observed fraction below = unknown
    unknown_margin: float = 1.5  # m: cap fully applies within this range
    unknown_ramp: float = 3.0  # m: cap -> max_velocity over this range
    # endgame radius of the goal-adjacent margin clamp
    goal_clamp_radius: float = 3.0


class EpisodeResult(NamedTuple):
    final_position: Tensor  # (..., 3)
    final_distance: Tensor  # (...,)
    min_distance: Tensor  # (...,) closest approach to goal
    tracking_rmse: Tensor  # (...,) plan-vs-actual position RMSE
    min_obstacle_clearance: Tensor  # (...,) surface clearance to TRUE world
    crashed: Tensor  # (...,) bool (ground or obstacle strike)
    success: Tensor  # (...,) bool


def resolve_method(method: str, device: torch.device) -> str:
    """"auto" -> "fused" on a CUDA device, "torch" on the CPU."""
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    if method == "auto":
        return "fused" if device.type == "cuda" else "torch"
    return method


def _with_margins(mpc, obs: Tensor, mask: Tensor, goal: Tensor, clamped: bool) -> Tensor:
    """Add the (optionally goal-clamped) safety margin to active radii.
    ``obs`` carries the episode batch already, so per-episode goals
    broadcast against it."""
    cfg = mpc if clamped else mpc._replace(goal_margin_clamp=0.0)
    out = obs.clone()
    out[..., 3] += torch.where(mask, se3_mpc.effective_margins(cfg, obs, goal), 0.0)
    return out


def _tick_loop(config: ClosedLoopConfig, rb, ctrl, t, res, goal, wind,
               true_obs, true_mask):
    """The per-tick loop of one block (the JAX package's scan path): returns
    the new plant and controller states, the time, and the block's metrics
    (min goal distance, summed squared tracking error, min altitude, min
    clearance)."""
    mpc = config.mpc
    pos = rb.position
    kw = dict(dtype=pos.dtype, device=pos.device)
    zero = torch.zeros((), **kw)
    h = config.control_dt / config.physics_substeps
    min_dist = min_alt = min_clear = track = None
    for sub_idx in range(config.substeps_per_plan):
        # the plan's linear interpolation at tau, in float32 on the host
        # (no device sync); frac is exact in float32
        tau = (torch.tensor(float(sub_idx)) + 1.0) * config.control_dt
        x = torch.clamp(tau / mpc.dt, 0.0, mpc.prediction_horizon - 1.001)
        i0 = int(torch.floor(x))
        frac = float(x - float(i0))

        def lerp(arr):
            lo, hi = arr[..., i0, :], arr[..., i0 + 1, :]
            return lo + frac * (hi - lo)

        sp = geometric.ControlSetpoint(
            position=lerp(res.positions),
            velocity=lerp(res.velocities),
            acceleration=lerp(res.accelerations),
            yaw=zero,
            yaw_rate=zero,
        )
        cmd, ctrl = geometric.compute_control(
            config.control, ctrl, rb.to_drone_state(t), sp, config.control_dt
        )
        for _ in range(config.physics_substeps):
            rb = phys.rigid_body_step(config.physics, rb, cmd, h, wind)
        p = rb.position
        dist = torch.linalg.vector_norm(p - goal, dim=-1)
        err = ((p - sp.position) ** 2).sum(-1)
        if true_obs is not None:
            clear_k = torch.linalg.vector_norm(
                p[..., None, :] - true_obs[..., :3], dim=-1
            ) - true_obs[..., 3]
            clear = torch.where(true_mask, clear_k, math.inf).amin(-1)
        else:
            clear = torch.full(dist.shape, 1e30, **kw)
        if min_dist is None:
            min_dist, track, min_alt, min_clear = dist, err, p[..., 2], clear
        else:
            min_dist = torch.minimum(min_dist, dist)
            track = track + err
            min_alt = torch.minimum(min_alt, p[..., 2])
            min_clear = torch.minimum(min_clear, clear)
        t = t + config.control_dt
    return rb, ctrl, t, (min_dist, track, min_alt, min_clear)


def simulate_episode(
    config: ClosedLoopConfig,
    generator: Optional[torch.Generator],
    state0: DroneState,
    goal: Tensor,
    obstacles: Optional[Tensor] = None,
    obstacle_mask: Optional[Tensor] = None,
    method: str = "auto",
    true_obstacles: Optional[Tensor] = None,
    true_obstacle_mask: Optional[Tensor] = None,
    corridor_observed: Optional[Tensor] = None,
    *,
    wind: Optional[Tensor] = None,
    noise: Optional[Tensor] = None,
) -> EpisodeResult:
    """Closed-loop episode(s), batched over the leading dims of ``state0``.

    ``obstacles`` (..., K, 4) is what the PLANNER sees (safety margin added
    here, as ``make_problem`` does); ``true_obstacles`` is the world the
    plant can strike, by default the planner set without margin. A shared
    (K, 4) set is broadcast to the batch before the margins are added, so
    the goal-clamped margins of batched goals come out per episode.
    ``corridor_observed`` (..., M) is the observed-fraction profile along
    the start -> goal corridor that drives ``config.unknown_speed_cap``.

    Randomness: ``wind`` (..., 3) and ``noise`` (num_replans, ..., 6, the
    additive position/velocity noise in m and m/s) may be given; what is
    not given is drawn from ``generator`` (a CPU generator), which may be
    None only when nothing is random."""
    mpc = config.mpc
    pos0 = state0.position
    device, dtype = pos0.device, pos0.dtype
    kw = dict(dtype=dtype, device=device)
    batch_shape = tuple(pos0.shape[:-1])
    method = resolve_method(method, device)
    use_tick_kernel = method == "fused"
    if use_tick_kernel and len(batch_shape) != 1:
        return _flat_episode(
            config, generator, state0, goal, obstacles, obstacle_mask, method,
            true_obstacles, true_obstacle_mask, corridor_observed, wind, noise,
        )
    with span("loop.prepare"):
        solve_method = "auto" if method == "fused" else "torch"
        goal = torch.as_tensor(goal, **kw).expand(batch_shape + (3,))

        def batched(x, trailing):
            return x.expand(batch_shape + tuple(x.shape[-trailing:]))

        K = mpc.max_obstacles
        if obstacles is None:
            obstacles = torch.zeros((K, 4), **kw)
            obstacle_mask = torch.zeros((K,), dtype=torch.bool, device=device)
        else:
            obstacles = torch.as_tensor(obstacles, **kw)
            if obstacle_mask is None:
                obstacle_mask = torch.ones(obstacles.shape[:-1], dtype=torch.bool, device=device)
            if true_obstacles is None:
                true_obstacles, true_obstacle_mask = obstacles, obstacle_mask
        obstacles = batched(obstacles, 2)
        obstacle_mask = batched(torch.as_tensor(obstacle_mask, device=device), 1)
        track_collisions = true_obstacles is not None
        if track_collisions:
            true_obstacles = batched(torch.as_tensor(true_obstacles, **kw), 2)
            if true_obstacle_mask is None:
                true_obstacle_mask = torch.ones(
                    true_obstacles.shape[:-1], dtype=torch.bool, device=device
                )
            true_obstacle_mask = batched(
                torch.as_tensor(true_obstacle_mask, device=device), 1
            )

        # margins: full always; goal-clamped for the endgame when enabled
        gate_clamp = mpc.goal_margin_clamp > 0.0
        use_sensing = config.sense_radius > 0.0 and track_collisions

        def plan_set(clamped):
            obs = _with_margins(mpc, obstacles, obstacle_mask, goal, clamped)
            if use_sensing:
                sensed = _with_margins(
                    mpc, true_obstacles, true_obstacle_mask, goal, clamped
                )
                obs = torch.cat([obs, sensed], dim=-2)
            return obs

        plan_obs = plan_set(False)
        plan_obs_clamped = plan_set(True) if gate_clamp else None

        use_vcap = config.unknown_speed_cap > 0.0 and corridor_observed is not None
        if use_vcap:
            corridor_observed = torch.as_tensor(corridor_observed, **kw)
            M = corridor_observed.shape[-1]
            tgrid = unit_linspace(M, **kw)
            corr_pts = pos0[..., None, :] + tgrid[:, None] * (goal - pos0)[..., None, :]
            corr_unknown = corridor_observed < config.unknown_coverage

        if wind is None:
            if config.wind_mean == 0.0 and config.wind_std == 0.0:
                wind = torch.zeros(batch_shape + (3,), **kw)
            else:
                _need(generator, "wind")
                wind = phys.sample_wind(
                    generator, batch_shape, config.wind_mean, config.wind_std,
                    dtype, device,
                )
        wind = torch.as_tensor(wind, **kw).expand(batch_shape + (3,))
        if noise is None and config.sensor_noise_std > 0.0:
            _need(generator, "sensor noise")
            noise = config.sensor_noise_std * torch.randn(
                (config.num_replans,) + batch_shape + (6,), generator=generator,
                dtype=dtype,
            ).to(device)
        elif noise is not None:
            noise = torch.as_tensor(noise, **kw)

        rb = phys.RigidBodyState.from_drone_state(state0)
        ctrl = geometric.ControllerState.zeros(config.control, batch_shape, dtype, device)
        u_warm = vector((0.0, 0.0, mpc.hover_thrust), dtype, device).expand(
            batch_shape + (mpc.prediction_horizon, 3))
        t = state0.timestamp.to(dtype)
        n_sub = config.substeps_per_plan

        back_calc = cuda_rollout.back_calculation(config.control)
        if use_tick_kernel:
            B = batch_shape[0]
            S = cuda_rollout.pack_state(rb, ctrl, back_calc)
            gw = torch.cat(
                [goal.T, wind.T, torch.zeros((2, B), **kw)], dim=0
            ).contiguous()
            obs_rows = None
            if track_collisions:
                obs_rows = cuda_rollout.pack_obstacles(true_obstacles, true_obstacle_mask)

    blocks = []
    for block in range(config.num_replans):
        with span("loop.replan"):
            if use_tick_kernel:
                p_now, v_now = S[0:3].T, S[3:6].T
            else:
                p_now, v_now = rb.position, rb.velocity
            v_cap = None
            if use_vcap:
                with span("loop.speed_cap"):
                    # distance to the nearest UNKNOWN corridor sample; the cap ramps
                    # from unknown_speed_cap (adjacent) to max_velocity
                    d = torch.linalg.vector_norm(p_now[..., None, :] - corr_pts, dim=-1)
                    d_unk = torch.where(corr_unknown, d, math.inf).amin(-1)
                    ramp = torch.clamp(
                        (d_unk - config.unknown_margin) / config.unknown_ramp, 0.0, 1.0
                    )
                    v_cap = (
                        config.unknown_speed_cap
                        + (mpc.max_velocity - config.unknown_speed_cap) * ramp
                    )
            obs_b = plan_obs
            if gate_clamp:
                with span("loop.margins"):
                    # clamped margins only inside the endgame ball around the goal
                    near = (torch.linalg.vector_norm(p_now - goal, dim=-1)
                            < config.goal_clamp_radius)
                    obs_b = torch.where(near[..., None, None], plan_obs_clamped, plan_obs)
            mask_b = obstacle_mask
            if use_sensing:
                with span("loop.sensing"):
                    gap = torch.linalg.vector_norm(
                        p_now[..., None, :] - true_obstacles[..., :3], dim=-1
                    ) - true_obstacles[..., 3]
                    sensed = true_obstacle_mask & (gap <= config.sense_radius)
                    mask_b = torch.cat([obstacle_mask, sensed], dim=-1)
            with span("loop.problem"):
                p_meas, v_meas = p_now, v_now
                if noise is not None:
                    p_meas = p_now + noise[block, ..., :3]
                    v_meas = v_now + noise[block, ..., 3:]
                prob = costs.Problem(
                    p0=p_meas, v0=v_meas, goal=goal, obstacles=obs_b,
                    obstacle_mask=mask_b, v_cap=v_cap,
                )
            res = se3_mpc.solve(
                mpc, prob, se3_mpc.shift_warm_start(mpc, u_warm), method=solve_method
            )
            u_warm = res.thrusts

            if use_tick_kernel:
                spp, spv, spa = cuda_rollout.setpoints_from_plan(
                    res.positions, res.velocities, res.accelerations,
                    n_sub, config.control_dt, mpc.dt,
                )
                S, acc = cuda_rollout.run_tick_block(
                    config.control, config.physics, config.control_dt, n_sub,
                    config.physics_substeps, S, spp, spv, spa, gw, obs_rows,
                )
                t = t + n_sub * config.control_dt
                blocks.append(acc[:4])
            else:
                rb, ctrl, t, metrics = _tick_loop(
                    config, rb, ctrl, t, res, goal, wind,
                    true_obstacles if track_collisions else None,
                    true_obstacle_mask,
                )
                blocks.append(torch.stack(metrics))

    with span("loop.outcome"):
        if use_tick_kernel:
            rb, _ = cuda_rollout.unpack_state(S, rb, ctrl, back_calc)
        stats = torch.stack(blocks)  # (num_replans, 4, ...)
        final_dist = torch.linalg.vector_norm(rb.position - goal, dim=-1)
        min_dist = torch.minimum(stats[:, 0].amin(0), final_dist)
        rmse = torch.sqrt(stats[:, 1].sum(0) / (config.num_replans * n_sub))
        min_clear = stats[:, 3].amin(0)
        crashed = (stats[:, 2].amin(0) < config.min_altitude) | (min_clear < 0.0)
        return EpisodeResult(
            final_position=rb.position,
            final_distance=final_dist,
            min_distance=min_dist,
            tracking_rmse=rmse,
            min_obstacle_clearance=min_clear,
            crashed=crashed,
            success=(final_dist < config.goal_tolerance) & ~crashed,
        )


def _flat_episode(config, generator, state0, goal, obstacles, obstacle_mask, method,
                  true_obstacles, true_obstacle_mask, corridor_observed, wind, noise):
    """:func:`simulate_episode` of a batch of any other rank than one, on
    one batch axis: every per-episode input broadcast to the batch and
    flattened in row-major order (the draws of ``generator`` come in that
    order too), the episode flown, and each result field given the batch
    shape back."""
    batch_shape = tuple(state0.position.shape[:-1])
    B = math.prod(batch_shape)

    def flat(x, trailing, lead=()):
        if x is None:
            return None
        x = torch.as_tensor(x, device=state0.position.device)
        x = x.expand(lead + batch_shape + tuple(x.shape[x.ndim - trailing:]))
        return x.reshape(lead + (B,) + tuple(x.shape[x.ndim - trailing:]))

    state = state0.replace(
        timestamp=flat(state0.timestamp, 0), position=flat(state0.position, 1),
        velocity=flat(state0.velocity, 1), attitude=flat(state0.attitude, 1),
        angular_velocity=flat(state0.angular_velocity, 1),
    )
    res = simulate_episode(
        config, generator, state, flat(goal, 1), flat(obstacles, 2),
        flat(obstacle_mask, 1), method, flat(true_obstacles, 2),
        flat(true_obstacle_mask, 1), flat(corridor_observed, 1),
        wind=flat(wind, 1), noise=flat(noise, 1, (config.num_replans,)),
    )
    return EpisodeResult(*(x.reshape(batch_shape + x.shape[1:]) for x in res))


def _need(generator, what: str) -> None:
    if generator is None:
        raise ValueError(f"the {what} is random: pass a torch.Generator or the draws")


def sample_fleet(
    generator: torch.Generator,
    num_episodes: int,
    start_center,
    goal_center,
    start_spread: float = 2.0,
    goal_spread: float = 2.0,
) -> tuple[torch.Generator, DroneState, Tensor]:
    """Randomized fleet initial conditions: (generator, states, goals).

    Starts and goals are drawn on ``generator`` (a CPU generator) and put
    on ``start_center``'s device (the card when it is not a tensor). The
    generator comes back first, in the place of the JAX package's episode
    key: the episode's draws continue its stream."""
    device = (start_center.device if isinstance(start_center, Tensor)
              else default_device())
    f32 = torch.float32
    sc = torch.as_tensor(start_center, dtype=f32).cpu()
    gc = torch.as_tensor(goal_center, dtype=f32).cpu()
    n = num_episodes
    starts = sc + start_spread * torch.randn((n, 3), generator=generator, dtype=f32)
    starts[:, 2] = torch.clamp(starts[:, 2], min=1.0)
    goals = gc + goal_spread * torch.randn((n, 3), generator=generator, dtype=f32)
    goals[:, 2] = torch.clamp(goals[:, 2], min=1.0)
    states = DroneState.zeros((n,), dtype=f32, device=device).replace(
        position=starts.to(device)
    )
    return generator, states, goals.to(device)


def monte_carlo(
    config: ClosedLoopConfig,
    generator: torch.Generator,
    num_episodes: int,
    start_center,
    goal_center,
    start_spread: float = 2.0,
    goal_spread: float = 2.0,
    obstacles: Optional[Tensor] = None,
    obstacle_mask: Optional[Tensor] = None,
    method: str = "auto",
    true_obstacles: Optional[Tensor] = None,
    true_obstacle_mask: Optional[Tensor] = None,
) -> EpisodeResult:
    """A randomized fleet as one batched episode call."""
    gen, states, goals = sample_fleet(
        generator, num_episodes, start_center, goal_center, start_spread,
        goal_spread,
    )
    return simulate_episode(
        config, gen, states, goals, obstacles, obstacle_mask, method=method,
        true_obstacles=true_obstacles, true_obstacle_mask=true_obstacle_mask,
    )
