"""C2-continuous trajectory splicing, branch-free and batched (PyTorch
counterpart of :mod:`dart_planner_tpu.control.smoother`).

The same semantics as the JAX package: a minimum-jerk transition when a
new plan jumps, linear interpolation of the active plan with endpoint
clamping, velocity/acceleration/jerk rate limits over the real elapsed
time, exponential smoothing, and the comms-timeout failsafe hold. A pure
``(config, state, inputs) -> (outputs, state)`` function over a
:class:`SmootherState` of tensors. Where the JAX package ``vmap``s one
smoother over a fleet, every field here may carry leading batch dims
``(B, ...)`` and one call serves the whole fleet: every select is a
``torch.where`` mask, never a branch on a tensor.

One deliberate difference, selected by ``SmootherConfig.rate_limits``: the
JAX package rate-limits each command over the elapsed ``dt`` and then
smooths it exponentially with ``alpha = dt / 0.1``, so each tick's step is
cut twice, by the limit (``~dt``) and by ``alpha`` (``~dt``): the limits it
enforces shrink with the loop rate, and at 400 Hz the acceleration command
slews at 1.5 m/s^3 instead of 60. At the deployment's 400 Hz control and
50 Hz replans that lag makes the simulated vehicle orbit its waypoint with
a growing radius (ROADMAP, the reference's known faults). The port's
default, ``"after_smoothing"``, smooths first and then limits the smoothed
command's change, so both the filter's time constant and the limits hold
at any loop rate; ``"before_smoothing"`` is the JAX package's order, and
the two agree wherever no limit is active.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from dart_planner_tpu_torch.common.device import resolve_device
from dart_planner_tpu_torch.common.types import DroneState, Trajectory, _Replace

Tensor = torch.Tensor


class SmootherConfig(NamedTuple):
    """Static smoother parameters: the JAX package's fields and defaults."""

    transition_time: float = 0.5  # s, min-jerk blend duration
    velocity_limit: float = 20.0  # m/s^2: max setpoint-velocity slew
    acceleration_limit: float = 60.0  # m/s^3: max setpoint-accel slew
    jerk_limit: float = 60.0  # m/s^3 bound on accel change (legacy knob)
    pos_jump_threshold: float = 0.5  # m
    vel_jump_threshold: float = 1.0  # m/s
    failsafe_timeout: float = 2.0  # s without a plan update
    smoothing_dt: float = 0.01  # assumed command rate of the first call
    # "after_smoothing": limits on the smoothed command (rate-invariant);
    # "before_smoothing": the JAX package's order (see the module docstring)
    rate_limits: str = "after_smoothing"


@dataclass
class SmootherState(_Replace):
    """Explicit smoother state; ``horizon`` is fixed at creation. Shapes
    below are per smoother; a fleet prepends its batch dims to each."""

    positions: Tensor  # (N, 3) active plan
    velocities: Tensor  # (N, 3)
    accelerations: Tensor  # (N, 3)
    timestamps: Tensor  # (N,)
    traj_start_time: Tensor  # ()
    last_update_time: Tensor  # ()
    has_trajectory: Tensor  # () bool
    in_transition: Tensor  # () bool
    transition_start_time: Tensor  # ()
    trans_p0: Tensor  # (3,)
    trans_v0: Tensor  # (3,)
    trans_p1: Tensor  # (3,)
    trans_v1: Tensor  # (3,)
    last_pos: Tensor  # (3,) exponential-smoothing memory
    last_vel: Tensor  # (3,)
    last_acc: Tensor  # (3,)
    last_call_time: Tensor  # () for real-dt rate limiting
    primed: Tensor  # () bool: smoothing memory valid

    @classmethod
    def zeros(cls, horizon: int, batch_shape: tuple = (), dtype=torch.float32,
              device=None) -> "SmootherState":
        batch_shape = tuple(batch_shape)
        device = resolve_device(device)

        def full(trailing, value, dt=dtype):
            return torch.full(batch_shape + trailing, value, dtype=dt, device=device)

        return cls(
            positions=full((horizon, 3), 0.0),
            velocities=full((horizon, 3), 0.0),
            accelerations=full((horizon, 3), 0.0),
            timestamps=full((horizon,), 0.0),
            traj_start_time=full((), 0.0),
            last_update_time=full((), -1e9),
            has_trajectory=full((), False, torch.bool),
            in_transition=full((), False, torch.bool),
            transition_start_time=full((), 0.0),
            trans_p0=full((3,), 0.0),
            trans_v0=full((3,), 0.0),
            trans_p1=full((3,), 0.0),
            trans_v1=full((3,), 0.0),
            last_pos=full((3,), 0.0),
            last_vel=full((3,), 0.0),
            last_acc=full((3,), 0.0),
            last_call_time=full((), -1.0),
            primed=full((), False, torch.bool),
        )


def _interpolate(ts: Tensor, pos: Tensor, vel: Tensor, acc: Tensor, t_rel: Tensor):
    """Linear interpolation with endpoint clamping. ``ts`` (..., N), the
    fields (..., N, 3) and ``t_rel`` (...) broadcast against each other."""
    rel = ts - ts[..., :1]
    N = rel.shape[-1]
    batch = torch.broadcast_shapes(rel.shape[:-1], t_rel.shape)
    # searchsorted needs the sorted rows and the queries on equal leading dims
    rel = rel.expand(batch + (N,)).contiguous()
    t_rel = t_rel.expand(batch)
    idx = torch.searchsorted(rel, t_rel[..., None].contiguous(), right=True)[..., 0]
    idx = torch.clamp(idx - 1, 0, N - 2)
    t1 = torch.gather(rel, -1, idx[..., None])[..., 0]
    t2 = torch.gather(rel, -1, idx[..., None] + 1)[..., 0]
    alpha = torch.clamp((t_rel - t1) / torch.clamp(t2 - t1, min=1e-9), 0.0, 1.0)
    at = idx[..., None, None].expand(batch + (1, 3))

    def pick(arr):
        arr = arr.expand(batch + arr.shape[-2:])
        lo = torch.gather(arr, -2, at)[..., 0, :]
        hi = torch.gather(arr, -2, at + 1)[..., 0, :]
        return lo + alpha[..., None] * (hi - lo)

    return pick(pos), pick(vel), pick(acc)


def _min_jerk(p0, v0, p1, v1, T: float, tau: Tensor):
    """Quintic minimum-jerk blend with a(0) = a(T) = 0."""
    s = torch.clamp(tau / T, 0.0, 1.0)[..., None]
    s2 = s * s
    s3 = s2 * s
    s4 = s3 * s
    s5 = s4 * s
    h00 = 1 - 10 * s3 + 15 * s4 - 6 * s5
    h01 = 10 * s3 - 15 * s4 + 6 * s5
    h10 = T * (s - 6 * s3 + 8 * s4 - 3 * s5)
    h11 = T * (-4 * s3 + 7 * s4 - 3 * s5)
    pos = h00 * p0 + h01 * p1 + h10 * v0 + h11 * v1
    d00 = (-30 * s2 + 60 * s3 - 30 * s4) / T
    d01 = (30 * s2 - 60 * s3 + 30 * s4) / T
    d10 = 1 - 18 * s2 + 32 * s3 - 15 * s4
    d11 = -12 * s2 + 28 * s3 - 15 * s4
    vel = d00 * p0 + d01 * p1 + d10 * v0 + d11 * v1
    a00 = (-60 * s + 180 * s2 - 120 * s3) / (T * T)
    a01 = (60 * s - 180 * s2 + 120 * s3) / (T * T)
    a10 = (-36 * s + 96 * s2 - 60 * s3) / T
    a11 = (-24 * s + 84 * s2 - 60 * s3) / T
    acc = a00 * p0 + a01 * p1 + a10 * v0 + a11 * v1
    return pos, vel, acc


def _limit(x: Tensor, last: Tensor, lim: Tensor) -> Tensor:
    """``x`` with its change from ``last`` cut to norm ``lim`` (..., 1)."""
    d = x - last
    mag = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return torch.where(mag > lim, last + d * (lim / torch.clamp(mag, min=1e-9)), x)


def _slew_limits(config: SmootherConfig, state: SmootherState, vel, acc, dt1):
    """Velocity/accel-change and jerk limits over the real elapsed time
    ``dt1`` (..., 1) since the last command."""
    vel = _limit(vel, state.last_vel, config.velocity_limit * dt1)
    acc = _limit(acc, state.last_acc, config.acceleration_limit * dt1)
    jerk = (acc - state.last_acc) / dt1
    j_mag = torch.linalg.vector_norm(jerk, dim=-1, keepdim=True)
    acc = torch.where(
        j_mag > config.jerk_limit,
        state.last_acc + jerk * (config.jerk_limit / torch.clamp(j_mag, min=1e-9)) * dt1,
        acc,
    )
    return vel, acc


def _rate_limit(config: SmootherConfig, state: SmootherState, pos, vel, acc, dt):
    """Rate limits and exponential smoothing (time constant 0.1 s), the
    smoothing masked by ``primed``, in the order ``config.rate_limits``
    names."""
    if config.rate_limits not in ("after_smoothing", "before_smoothing"):
        raise ValueError(f"unknown rate_limits order {config.rate_limits!r}")
    dt1 = dt[..., None]
    if config.rate_limits == "before_smoothing":
        vel, acc = _slew_limits(config, state, vel, acc, dt1)

    alpha = torch.clamp(dt / 0.1, max=1.0)[..., None]
    primed = state.primed[..., None]
    pos = torch.where(primed, alpha * pos + (1 - alpha) * state.last_pos, pos)
    vel = torch.where(primed, alpha * vel + (1 - alpha) * state.last_vel, vel)
    acc = torch.where(primed, alpha * acc + (1 - alpha) * state.last_acc, acc)

    if config.rate_limits == "after_smoothing":
        vel, acc = _slew_limits(config, state, vel, acc, dt1)
    return pos, vel, acc


def _time(current_time, state: SmootherState) -> Tensor:
    like = state.positions
    return torch.as_tensor(current_time, dtype=like.dtype, device=like.device)


def update_trajectory(
    config: SmootherConfig,
    state: SmootherState,
    trajectory: Trajectory,
    current_time,
) -> SmootherState:
    """Accept a new plan; start a min-jerk transition on a jump. Pure:
    returns the new state. The plan's tensors must be on the state's
    device."""
    t = _time(current_time, state)
    # desired state of the OLD plan now
    old_p, old_v, _ = _interpolate(
        state.timestamps, state.positions, state.velocities, state.accelerations,
        t - state.traj_start_time,
    )
    # start of the new plan (jump detection)
    new_p = trajectory.positions[..., 0, :]
    new_v = trajectory.velocities[..., 0, :]
    # transition TARGET: where the new plan will be when the blend ends
    tgt_p, tgt_v, _ = _interpolate(
        trajectory.timestamps, trajectory.positions, trajectory.velocities,
        trajectory.accelerations,
        torch.full((), config.transition_time, dtype=t.dtype, device=t.device),
    )

    pos_diff = torch.linalg.vector_norm(new_p - old_p, dim=-1)
    vel_diff = torch.linalg.vector_norm(new_v - old_v, dim=-1)
    jump = (pos_diff > config.pos_jump_threshold) | (vel_diff > config.vel_jump_threshold)
    start = state.has_trajectory & jump
    start3 = start[..., None]

    return state.replace(
        positions=trajectory.positions,
        velocities=trajectory.velocities,
        accelerations=trajectory.accelerations,
        timestamps=trajectory.timestamps,
        traj_start_time=t.expand_as(state.traj_start_time),
        last_update_time=t.expand_as(state.last_update_time),
        has_trajectory=torch.ones_like(state.has_trajectory),
        in_transition=start | state.in_transition,
        transition_start_time=torch.where(start, t, state.transition_start_time),
        trans_p0=torch.where(start3, old_p, state.trans_p0),
        trans_v0=torch.where(start3, old_v, state.trans_v0),
        trans_p1=torch.where(start3, tgt_p, state.trans_p1),
        trans_v1=torch.where(start3, tgt_v, state.trans_v1),
    )


def get_desired_state(
    config: SmootherConfig,
    state: SmootherState,
    current_time,
    drone_state: DroneState,
) -> tuple[tuple[Tensor, Tensor, Tensor], SmootherState]:
    """Smooth (pos, vel, acc) command at ``current_time``.

    Failsafe: hold the drone's current position when no plan update came
    for ``failsafe_timeout`` or there is no plan at all."""
    t = _time(current_time, state)

    dt_real = torch.clamp(t - state.last_call_time, config.smoothing_dt * 0.1, 0.1)
    dt_real = torch.where(
        state.primed, dt_real, torch.full_like(dt_real, config.smoothing_dt)
    )

    # normal interpolation of the active plan
    pos_n, vel_n, acc_n = _interpolate(
        state.timestamps, state.positions, state.velocities, state.accelerations,
        t - state.traj_start_time,
    )

    # min-jerk transition overlay
    tau = t - state.transition_start_time
    trans_done = tau >= config.transition_time
    pos_t, vel_t, acc_t = _min_jerk(
        state.trans_p0, state.trans_v0, state.trans_p1, state.trans_v1,
        config.transition_time, tau,
    )
    use_trans = (state.in_transition & ~trans_done)[..., None]
    pos = torch.where(use_trans, pos_t, pos_n)
    vel = torch.where(use_trans, vel_t, vel_n)
    acc = torch.where(use_trans, acc_t, acc_n)

    pos, vel, acc = _rate_limit(config, state, pos, vel, acc, dt_real)

    # failsafe hold (stale comms or no plan yet)
    stale = (t - state.last_update_time) > config.failsafe_timeout
    hold = (stale | ~state.has_trajectory)[..., None]
    pos = torch.where(hold, drone_state.position, pos)
    vel = torch.where(hold, 0.0, vel)
    acc = torch.where(hold, 0.0, acc)

    new_state = state.replace(
        in_transition=state.in_transition & ~trans_done,
        last_pos=pos,
        last_vel=vel,
        last_acc=acc,
        last_call_time=t.expand_as(state.last_call_time),
        primed=torch.ones_like(state.primed),
    )
    return (pos, vel, acc), new_state


class TrajectorySmoother:
    """Stateful facade over the pure functions, on one device (default:
    the card)."""

    def __init__(
        self,
        transition_time: float = 0.5,
        smoothing_factor: float = 0.8,
        horizon: int = 20,
        config: SmootherConfig | None = None,
        device=None,
    ):
        self.config = config or SmootherConfig(transition_time=transition_time)
        self.device = resolve_device(device)
        self.state = SmootherState.zeros(horizon, device=self.device)

    def update_trajectory(self, trajectory: Trajectory, current_time) -> None:
        self.state = update_trajectory(self.config, self.state, trajectory, current_time)

    def get_desired_state(self, current_time, drone_state: DroneState):
        (pos, vel, acc), self.state = get_desired_state(
            self.config, self.state, current_time, drone_state
        )
        return pos, vel, acc
