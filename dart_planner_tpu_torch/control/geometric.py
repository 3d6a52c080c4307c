"""Geometric SE(3) controller, functional and batched (PyTorch counterpart
of :mod:`dart_planner_tpu.control.geometric`).

The control law:

    acc_des = ff_acc + Kp e_p + Kd e_v + Ki (integral of e_v)
    f_world = acc_des - g_vec;  T = m ||f_world|| clipped
    b3 tilt-limited
    e_R = 0.5 vee(R_d^T R - R^T R_d)
    tau = -K_R e_R - K_Omega e_Omega + Omega x (I Omega)

as a pure function ``(config, ctrl_state, inputs) -> (command,
ctrl_state')`` with no data-dependent Python branches: the yaw-singularity
fallback, saturation, anti-windup and failsafe are ``torch.where`` masks,
so one code path serves a single vehicle and a batched fleet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from dart_planner_tpu_torch.common import frames
from dart_planner_tpu_torch.common.device import resolve_device
from dart_planner_tpu_torch.common.types import (
    BodyRateCommand,
    ControlCommand,
    DroneState,
    _Replace,
)
from dart_planner_tpu_torch.ops import so3

Tensor = torch.Tensor


class GeometricConfig(NamedTuple):
    """Static gains and limits: the same fields and defaults as the JAX
    package's ``GeometricConfig``."""

    kp_pos: tuple = (7.0, 7.0, 8.5)
    ki_pos: tuple = (0.35, 0.35, 0.7)
    kd_pos: tuple = (4.2, 4.2, 5.6)
    kp_att: tuple = (9.0, 9.0, 3.75)
    kd_att: tuple = (3.0, 3.0, 1.5)
    inertia: tuple = (0.02, 0.02, 0.04)
    max_torque_xyz: tuple = (5.4, 5.4, 0.36)
    ff_pos: float = 1.2
    ff_vel: float = 0.8
    max_integral_pos: float = 5.0
    max_tilt_angle: float = float(np.pi / 3)
    mass: float = 1.0
    gravity: float = 9.81
    max_thrust: float = 20.0
    min_thrust: float = 0.5  # fraction of hover: min * m * g
    tracking_error_threshold: float = 2.0
    velocity_error_threshold: float = 1.0
    anti_windup_method: str = "clamping"  # or "back_calculation"
    max_integral_per_axis: tuple = (2.0, 2.0, 3.0)
    back_calculation_gain: float = 0.1
    integral_decay_factor: float = 0.99
    saturation_threshold: float = 0.95
    yaw_singularity_threshold: float = 0.1
    default_heading_yaw: float = 0.0
    failsafe_trigger_count: int = 100
    # "lee": b2 = b3 x c, b1 = b2 x b3 (identity at hover). "reference":
    # the bug-compatible b1 = c x b3, which yaws the desired frame -90 deg
    # and commands a saturated yaw torque at hover.
    yaw_convention: str = "lee"


@dataclass
class ControllerState(_Replace):
    """Explicit controller state (batch-shaped tensors)."""

    integral_vel_error: Tensor  # (..., 3)
    last_thrust_saturated: Tensor  # (...,) bool
    last_torque_saturated: Tensor  # (..., 3) bool
    unsaturated_thrust: Tensor  # (...,)
    unsaturated_torque: Tensor  # (..., 3)
    failsafe_count: Tensor  # (...,) int32
    failsafe_active: Tensor  # (...,) bool
    last_valid_thrust: Tensor  # (...,)
    last_time: Tensor  # (...,)

    @classmethod
    def zeros(cls, config: GeometricConfig, batch_shape: tuple = (),
              dtype=torch.float32, device=None) -> "ControllerState":
        batch_shape = tuple(batch_shape)
        device = resolve_device(device)

        def full(shape, value, dt):
            return torch.full(shape, value, dtype=dt, device=device)

        return cls(
            integral_vel_error=full(batch_shape + (3,), 0.0, dtype),
            last_thrust_saturated=full(batch_shape, False, torch.bool),
            last_torque_saturated=full(batch_shape + (3,), False, torch.bool),
            unsaturated_thrust=full(batch_shape, 0.0, dtype),
            unsaturated_torque=full(batch_shape + (3,), 0.0, dtype),
            failsafe_count=full(batch_shape, 0, torch.int32),
            failsafe_active=full(batch_shape, False, torch.bool),
            last_valid_thrust=full(batch_shape, config.mass * config.gravity, dtype),
            last_time=full(batch_shape, -1.0, dtype),
        )


class ControlSetpoint(NamedTuple):
    """Desired state fed to the controller."""

    position: Tensor
    velocity: Tensor
    acceleration: Tensor
    yaw: Tensor
    yaw_rate: Tensor

    @classmethod
    def hover_at(cls, position, dtype=torch.float32, device=None) -> "ControlSetpoint":
        device = resolve_device(device)
        p = torch.as_tensor(position, dtype=dtype, device=device)
        z3 = torch.zeros_like(p)
        z = torch.zeros(p.shape[:-1], dtype=dtype, device=device)
        return cls(position=p, velocity=z3, acceleration=z3, yaw=z, yaw_rate=z)


def _const(values, like: Tensor) -> Tensor:
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def _unit(like: Tensor, axis: int) -> Tensor:
    e = torch.zeros_like(like)
    e[..., axis] = 1.0
    return e


def _cross(a: Tensor, b: Tensor) -> Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _desired_frame(config: GeometricConfig, b3_des: Tensor, yaw_des: Tensor) -> Tensor:
    """Desired rotation with a branch-free yaw-singularity fallback.

    Normal case: b1 from c = (cos yaw, sin yaw, 0) and b3 by the configured
    convention. When |c . b3| >= yaw_singularity_threshold, b1 comes from
    projecting e1 onto b3's orthogonal plane (e1 itself when b3 is within
    0.99 of straight up or down). Both are computed and selected by mask."""
    c = torch.stack(
        [torch.cos(yaw_des), torch.sin(yaw_des), torch.zeros_like(yaw_des)], dim=-1
    )
    cos_angle = (c * b3_des).sum(-1).abs()
    singular = cos_angle >= config.yaw_singularity_threshold

    if config.yaw_convention == "reference":
        b1_normal_raw = _cross(c, b3_des)
    else:
        b1_normal_raw = _cross(_cross(b3_des, c), b3_des)
    n1 = torch.linalg.vector_norm(b1_normal_raw, dim=-1, keepdim=True)
    ok = n1 > 1e-6
    e1 = _unit(b3_des, 0)
    b1_unit = b1_normal_raw / torch.where(ok, n1, torch.ones_like(n1))
    b1_normal = torch.where(ok, b1_unit, e1)

    straight = b3_des[..., 2:3].abs() >= 0.99
    proj = e1 - (e1 * b3_des).sum(-1, keepdim=True) * b3_des
    b1_skip = so3.normalize(proj, fallback=e1)
    b1_skip = torch.where(straight, e1, b1_skip)

    b1 = torch.where(singular[..., None], b1_skip, b1_normal)
    b2 = _cross(b3_des, b1)
    return torch.stack([b1, b2, b3_des], dim=-1)


def _tilt_limit(config: GeometricConfig, b3: Tensor) -> Tensor:
    """Azimuth-preserving tilt limit: an over-tilted b3 is projected to the
    max-tilt cone, (sin_max * unit(xy), cos_max)."""
    cos_max = math.cos(config.max_tilt_angle)
    sin_max = math.sin(config.max_tilt_angle)
    over = b3[..., 2] < cos_max
    xy = b3[..., :2]
    xy_norm = torch.linalg.vector_norm(xy, dim=-1, keepdim=True)
    dir_xy = xy / torch.clamp(xy_norm, min=1e-9)
    b3_lim = torch.cat([sin_max * dir_xy, torch.full_like(b3[..., 2:3], cos_max)], dim=-1)
    return torch.where(over[..., None], b3_lim, b3)


def compute_control(
    config: GeometricConfig,
    state: ControllerState,
    drone: DroneState,
    setpoint: ControlSetpoint,
    dt=0.001,
) -> tuple[ControlCommand, ControllerState]:
    """One control tick, batched over any leading dims.

    Returns the command and the updated controller state. An invalid dt
    (<= 0 or > 0.1 s) or a persistent tracking failure gives the failsafe
    command (last valid thrust, zero torque), selected by mask."""
    pos = drone.position
    dt = torch.as_tensor(dt, dtype=pos.dtype, device=pos.device)
    kp = _const(config.kp_pos, pos)
    ki = _const(config.ki_pos, pos)
    kd = _const(config.kd_pos, pos)
    kp_att = _const(config.kp_att, pos)
    kd_att = _const(config.kd_att, pos)
    inertia = _const(config.inertia, pos)
    max_torque = _const(config.max_torque_xyz, pos)
    gvec = frames.gravity_vector(
        frames.WorldFrame.ENU, config.gravity, dtype=pos.dtype, device=pos.device
    )

    pos_error = setpoint.position - pos
    vel_error = setpoint.velocity - drone.velocity
    pos_err_mag = torch.linalg.vector_norm(pos_error, dim=-1)
    vel_err_mag = torch.linalg.vector_norm(vel_error, dim=-1)

    # desired acceleration: PID + feedforward
    acc_pid = kp * pos_error + kd * vel_error + ki * state.integral_vel_error
    acc_des = setpoint.acceleration + acc_pid

    # thrust vector and magnitude (Newtons: m * ||a||, as the JAX package)
    f_world = acc_des - gvec
    thrust_mag_raw = config.mass * torch.linalg.vector_norm(f_world, dim=-1)
    min_thrust = config.min_thrust * config.mass * config.gravity
    thrust_mag = torch.clamp(thrust_mag_raw, min_thrust, config.max_thrust)
    thrust_saturated = thrust_mag_raw != thrust_mag

    # integral update with anti-windup
    integral_update = vel_error * dt
    if config.anti_windup_method == "clamping":
        # saturated axes accumulate at 10%
        damp = torch.where(thrust_saturated[..., None], 0.1, 1.0)
        damp = damp * torch.where(state.last_torque_saturated, 0.1, 1.0)
        integral_update = integral_update * damp
    else:  # back_calculation
        Kb = config.back_calculation_gain
        thrust_fb = torch.where(
            thrust_saturated,
            (state.unsaturated_thrust - config.max_thrust) * Kb,
            0.0,
        )
        integral_update = integral_update - thrust_fb[..., None] * _const(
            [0.33, 0.33, 0.34], pos
        )
        torque_fb = torch.where(
            state.last_torque_saturated,
            (state.unsaturated_torque - max_torque) * Kb,
            0.0,
        )
        integral_update = integral_update - torque_fb * 0.5

    integral = state.integral_vel_error + integral_update
    per_axis = _const(config.max_integral_per_axis, pos)
    integral = torch.clamp(integral, -per_axis, per_axis)
    mag = torch.linalg.vector_norm(integral, dim=-1, keepdim=True)
    integral = torch.where(
        mag > config.max_integral_pos,
        integral * (config.max_integral_pos / torch.clamp(mag, min=1e-9)),
        integral,
    )
    near = integral.abs() > per_axis * config.saturation_threshold
    integral = torch.where(near, integral * config.integral_decay_factor, integral)

    # desired thrust direction with tilt limit
    up = _unit(f_world, 2)
    tm_ok = thrust_mag > 1e-6
    b3_des = torch.where(
        tm_ok[..., None],
        f_world / torch.clamp(thrust_mag_raw, min=1e-9)[..., None],
        up,
    )
    b3_des = so3.normalize(b3_des, fallback=up)
    b3_des = _tilt_limit(config, b3_des)

    # geometric attitude control
    R = so3.euler_to_rotmat(drone.attitude)
    R_des = _desired_frame(config, b3_des, setpoint.yaw)
    eR = so3.attitude_error(R, R_des)
    zero_rate = torch.zeros_like(setpoint.yaw_rate)
    omega_des = torch.stack([zero_rate, zero_rate, setpoint.yaw_rate], dim=-1)
    omega = drone.angular_velocity
    eOmega = omega - omega_des
    coriolis = _cross(omega, inertia * omega)
    torque_raw = -kp_att * eR - kd_att * eOmega + coriolis
    torque = torch.clamp(torque_raw, -max_torque, max_torque)
    torque_saturated = torque_raw != torque

    # failsafe
    bad_tracking = (pos_err_mag > config.tracking_error_threshold) & (
        vel_err_mag > config.velocity_error_threshold
    )
    failsafe_count = torch.where(
        bad_tracking,
        state.failsafe_count + 1,
        torch.clamp(state.failsafe_count - 1, min=0),
    )
    dt_invalid = (dt <= 0) | (dt > 0.1)
    failsafe = dt_invalid | (failsafe_count > config.failsafe_trigger_count)

    thrust_out = torch.where(failsafe, state.last_valid_thrust, thrust_mag)
    torque_out = torch.where(failsafe[..., None], 0.0, torque)

    new_state = ControllerState(
        integral_vel_error=torch.where(failsafe[..., None], 0.0, integral),
        last_thrust_saturated=thrust_saturated,
        last_torque_saturated=torque_saturated,
        unsaturated_thrust=thrust_mag_raw,
        unsaturated_torque=torque_raw,
        failsafe_count=failsafe_count,
        failsafe_active=failsafe,
        last_valid_thrust=torch.where(failsafe, state.last_valid_thrust, thrust_mag),
        last_time=drone.timestamp,
    )
    return ControlCommand(thrust=thrust_out, torque=torque_out), new_state


def compute_body_rate_command(
    config: GeometricConfig,
    state: ControllerState,
    drone: DroneState,
    setpoint: ControlSetpoint,
    dt=0.001,
) -> tuple[BodyRateCommand, ControllerState]:
    """PX4-offboard body-rate command: integrate the torque through the
    nominal inertia for one tick and normalize thrust."""
    cmd, new_state = compute_control(config, state, drone, setpoint, dt)
    inertia = _const([0.1, 0.1, 0.2], drone.position)
    ang_acc = cmd.torque / inertia
    rates = drone.angular_velocity + ang_acc * 0.001
    thrust_norm = torch.clamp(cmd.thrust / config.max_thrust, 0.0, 1.0)
    return BodyRateCommand(thrust=thrust_norm, body_rates=rates), new_state


class GeometricController:
    """Stateful facade over :func:`compute_control` (one vehicle, one
    device). Halves the gains on the first failsafe activation, which is
    stateful and so lives here rather than in the pure function."""

    def __init__(self, config: GeometricConfig | None = None, device=None):
        self.config = config or GeometricConfig()
        self.device = resolve_device(device)
        self.state = ControllerState.zeros(self.config, device=self.device)
        self._was_failsafe = False
        self.position_errors: list[float] = []
        self.velocity_errors: list[float] = []

    def compute_control(
        self, drone: DroneState, desired_pos, desired_vel, desired_acc,
        desired_yaw=0.0, desired_yaw_rate=0.0,
    ) -> ControlCommand:
        kw = dict(dtype=drone.position.dtype, device=drone.position.device)
        sp = ControlSetpoint(
            position=torch.as_tensor(desired_pos, **kw),
            velocity=torch.as_tensor(desired_vel, **kw),
            acceleration=torch.as_tensor(desired_acc, **kw),
            yaw=torch.as_tensor(desired_yaw, **kw),
            yaw_rate=torch.as_tensor(desired_yaw_rate, **kw),
        )
        last = float(self.state.last_time)
        dt = float(drone.timestamp) - last if last >= 0 else 0.001
        cmd, self.state = compute_control(self.config, self.state, drone, sp, dt)
        active = bool(self.state.failsafe_active)
        if active and not self._was_failsafe:
            # first activation: halve the gains
            self.config = self.config._replace(
                kp_pos=tuple(g * 0.5 for g in self.config.kp_pos),
                kd_pos=tuple(g * 0.5 for g in self.config.kd_pos),
                kp_att=tuple(g * 0.5 for g in self.config.kp_att),
                kd_att=tuple(g * 0.5 for g in self.config.kd_att),
            )
        self._was_failsafe = active
        self.position_errors.append(
            float(torch.linalg.vector_norm(sp.position - drone.position))
        )
        self.velocity_errors.append(
            float(torch.linalg.vector_norm(sp.velocity - drone.velocity))
        )
        return cmd

    def reset(self) -> None:
        self.state = ControllerState.zeros(self.config, device=self.device)
        self._was_failsafe = False
        self.position_errors.clear()
        self.velocity_errors.clear()

    def get_performance_metrics(self) -> dict:
        out = {
            "failsafe_activations": int(self.state.failsafe_count),
            "integral_magnitude": float(
                torch.linalg.vector_norm(self.state.integral_vel_error)
            ),
            "anti_windup_method": self.config.anti_windup_method,
        }
        if self.position_errors:
            out.update(
                mean_position_error=float(np.mean(self.position_errors)),
                max_position_error=float(np.max(self.position_errors)),
                mean_velocity_error=float(np.mean(self.velocity_errors)),
                total_samples=len(self.position_errors),
            )
        return out
