"""Drone physics (PyTorch counterpart of :mod:`dart_planner_tpu.sim.physics`).

- ``point_mass_step``: thrust along body z (``body_frame_thrust=True``) or
  world z, plus wind and linear drag; semi-implicit Euler.
- ``rigid_body_step``: the full SE(3) rigid body: R in SO(3) advanced by the
  exact exponential, Euler's equations with the gyroscopic term.

Both are pure ``(state, command, wind, dt) -> state`` and batch over any
leading dims. Rotation products go through :func:`so3.mm` (exact fp32).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from dart_planner_tpu_torch.common import frames
from dart_planner_tpu_torch.common.types import ControlCommand, DroneState, _Replace
from dart_planner_tpu_torch.ops import so3

Tensor = torch.Tensor


class PhysicsConfig(NamedTuple):
    """Static physics parameters (the JAX package's fields and defaults)."""

    mass: float = 1.5  # kg
    gravity: float = 9.81
    inertia: tuple = (0.02, 0.02, 0.04)  # diag, kg m^2
    max_thrust: float = 20.0  # N
    max_torque: float = 10.0  # N m
    drag_coefficient: float = 0.0  # linear drag / mass
    body_frame_thrust: bool = True


@dataclass
class RigidBodyState(_Replace):
    """Full rigid-body state with a rotation matrix (no Euler drift)."""

    position: Tensor  # (..., 3)
    velocity: Tensor  # (..., 3)
    rotation: Tensor  # (..., 3, 3)
    angular_velocity: Tensor  # (..., 3) body frame

    @classmethod
    def from_drone_state(cls, s: DroneState) -> "RigidBodyState":
        return cls(
            position=s.position,
            velocity=s.velocity,
            rotation=so3.euler_to_rotmat(s.attitude),
            angular_velocity=s.angular_velocity,
        )

    def to_drone_state(self, timestamp) -> DroneState:
        pos = self.position
        return DroneState(
            timestamp=torch.as_tensor(timestamp, dtype=pos.dtype, device=pos.device),
            position=pos,
            velocity=self.velocity,
            attitude=so3.rotmat_to_euler(self.rotation),
            angular_velocity=self.angular_velocity,
        )


def sample_wind(generator: torch.Generator, batch_shape: tuple, mean: float,
                std: float, dtype=torch.float32, device="cpu") -> Tensor:
    """Constant-per-episode wind vector: a uniform direction times a
    magnitude ~ N(mean, std). Drawn on ``generator`` (a CPU generator, so a
    CPU and a GPU run see the same winds), then moved to ``device``."""
    shape = tuple(batch_shape)
    direction = torch.randn(shape + (3,), generator=generator, dtype=dtype)
    direction = direction / torch.clamp(
        torch.linalg.vector_norm(direction, dim=-1, keepdim=True), min=1e-9
    )
    mag = mean + std * torch.randn(shape + (1,), generator=generator, dtype=dtype)
    return (direction * mag).to(device)


def _gravity(config: PhysicsConfig, like: Tensor) -> Tensor:
    return frames.gravity_vector(
        frames.WorldFrame.ENU, config.gravity, dtype=like.dtype, device=like.device
    )


def point_mass_step(
    config: PhysicsConfig,
    state: DroneState,
    command: ControlCommand,
    dt,
    wind: Optional[Tensor] = None,
) -> DroneState:
    """Semi-implicit Euler point-mass step."""
    pos0 = state.position
    dt = torch.as_tensor(dt, dtype=pos0.dtype, device=pos0.device)
    thrust = torch.clamp(command.thrust, 0.0, config.max_thrust)
    torque = torch.clamp(command.torque, -config.max_torque, config.max_torque)
    gvec = _gravity(config, pos0)

    if config.body_frame_thrust:
        thrust_dir = so3.euler_to_rotmat(state.attitude)[..., :, 2]
    else:
        thrust_dir = torch.zeros_like(pos0)
        thrust_dir[..., 2] = 1.0
    acc = gvec + thrust_dir * (thrust[..., None] / config.mass)
    if wind is not None:
        acc = acc + wind / config.mass
    if config.drag_coefficient > 0:
        acc = acc - config.drag_coefficient * state.velocity

    vel = state.velocity + acc * dt
    pos = pos0 + vel * dt
    inertia = torch.tensor(config.inertia, dtype=pos0.dtype, device=pos0.device)
    omega = state.angular_velocity + (torque / inertia) * dt
    return DroneState(
        timestamp=state.timestamp + dt,
        position=pos,
        velocity=vel,
        attitude=state.attitude + omega * dt,
        angular_velocity=omega,
    )


def rigid_body_step(
    config: PhysicsConfig,
    state: RigidBodyState,
    command: ControlCommand,
    dt,
    wind: Optional[Tensor] = None,
) -> RigidBodyState:
    """Full SE(3) step: thrust along body z, exact SO(3) exponential for the
    attitude, Euler-equation angular dynamics with the gyroscopic term."""
    pos0 = state.position
    dt = torch.as_tensor(dt, dtype=pos0.dtype, device=pos0.device)
    thrust = torch.clamp(command.thrust, 0.0, config.max_thrust)
    torque = torch.clamp(command.torque, -config.max_torque, config.max_torque)
    gvec = _gravity(config, pos0)

    b3 = state.rotation[..., :, 2]
    acc = gvec + b3 * (thrust[..., None] / config.mass)
    if wind is not None:
        acc = acc + wind / config.mass
    if config.drag_coefficient > 0:
        acc = acc - config.drag_coefficient * state.velocity
    vel = state.velocity + acc * dt
    pos = pos0 + vel * dt

    inertia = torch.tensor(config.inertia, dtype=pos0.dtype, device=pos0.device)
    w0 = state.angular_velocity
    w0, inertia_w = torch.broadcast_tensors(w0, inertia * w0)
    gyro = torch.linalg.cross(w0, inertia_w, dim=-1)
    omega = w0 + ((torque - gyro) / inertia) * dt
    R = so3.mm(state.rotation, so3.exp_so3(omega * dt))
    return RigidBodyState(position=pos, velocity=vel, rotation=R, angular_velocity=omega)
