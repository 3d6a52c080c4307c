"""Typed state / trajectory / command containers (PyTorch).

Counterpart of :mod:`dart_planner_tpu.common.types`: plain dataclasses of
SI-unit tensors. Every field may carry leading batch dimensions, so a
``DroneState`` is one vehicle or a fleet with no code change. Constructors
that make tensors take a ``dtype`` and a ``device`` (default: the card,
:func:`~dart_planner_tpu_torch.common.device.default_device`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from dart_planner_tpu_torch.common.device import resolve_device

Tensor = torch.Tensor


class _Replace:
    def replace(self, **changes):
        """Copy with some fields replaced (the flax ``struct`` idiom)."""
        return dataclasses.replace(self, **changes)


@dataclass
class DroneState(_Replace):
    """Complete vehicle state at an instant (SI units).

    - ``timestamp``:        s         (...)
    - ``position``:         m         (..., 3)
    - ``velocity``:         m/s       (..., 3)
    - ``attitude``:         rad       (..., 3) roll, pitch, yaw
    - ``angular_velocity``: rad/s     (..., 3)
    """

    timestamp: Tensor
    position: Tensor
    velocity: Tensor
    attitude: Tensor
    angular_velocity: Tensor

    @classmethod
    def zeros(
        cls, batch_shape: tuple = (), dtype=torch.float32, device=None
    ) -> "DroneState":
        device = resolve_device(device)

        def v3():
            return torch.zeros(batch_shape + (3,), dtype=dtype, device=device)

        return cls(
            timestamp=torch.zeros(batch_shape, dtype=dtype, device=device),
            position=v3(),
            velocity=v3(),
            attitude=v3(),
            angular_velocity=v3(),
        )

    @classmethod
    def create(
        cls,
        timestamp=0.0,
        position=(0.0, 0.0, 0.0),
        velocity=(0.0, 0.0, 0.0),
        attitude=(0.0, 0.0, 0.0),
        angular_velocity=(0.0, 0.0, 0.0),
        dtype=torch.float32,
        device=None,
    ) -> "DroneState":
        device = resolve_device(device)

        def t(x):
            return torch.as_tensor(x, dtype=dtype, device=device)

        return cls(
            timestamp=t(timestamp),
            position=t(position),
            velocity=t(velocity),
            attitude=t(attitude),
            angular_velocity=t(angular_velocity),
        )


@dataclass
class ControlCommand(_Replace):
    """Low-level controller output.

    - ``thrust``: N      (...,)   collective thrust magnitude
    - ``torque``: N*m    (..., 3) body roll/pitch/yaw moments
    """

    thrust: Tensor
    torque: Tensor

    @classmethod
    def zeros(
        cls, batch_shape: tuple = (), dtype=torch.float32, device=None
    ) -> "ControlCommand":
        device = resolve_device(device)
        return cls(
            thrust=torch.zeros(batch_shape, dtype=dtype, device=device),
            torque=torch.zeros(batch_shape + (3,), dtype=dtype, device=device),
        )


@dataclass
class BodyRateCommand(_Replace):
    """PX4-offboard style command.

    - ``thrust``: normalized [0, 1]
    - ``body_rates``: rad/s (..., 3)
    """

    thrust: Tensor
    body_rates: Tensor


@dataclass
class Trajectory(_Replace):
    """Time-indexed desired-state sequence from the planner.

    Shapes: ``timestamps`` (..., N); vector fields (..., N, 3);
    ``thrusts``/``yaws``/``yaw_rates`` (..., N).
    """

    timestamps: Tensor
    positions: Tensor
    velocities: Optional[Tensor] = None
    accelerations: Optional[Tensor] = None
    attitudes: Optional[Tensor] = None
    body_rates: Optional[Tensor] = None
    thrusts: Optional[Tensor] = None
    yaws: Optional[Tensor] = None
    yaw_rates: Optional[Tensor] = None

    @property
    def horizon(self) -> int:
        return self.timestamps.shape[-1]


@dataclass
class Pose(_Replace):
    """Position + orientation (roll, pitch, yaw in rad)."""

    position: Tensor
    orientation: Tensor


@dataclass
class Twist(_Replace):
    """Linear + angular velocity."""

    linear: Tensor
    angular: Tensor


@dataclass
class Accel(_Replace):
    """Linear + angular acceleration."""

    linear: Tensor
    angular: Tensor


@dataclass
class EstimatedState(_Replace):
    """Standardized state-estimator output."""

    timestamp: Tensor
    pose: Pose
    twist: Twist
    accel: Accel
    source: str = "unknown"

    def to_drone_state(self) -> DroneState:
        return DroneState(
            timestamp=self.timestamp,
            position=self.pose.position,
            velocity=self.twist.linear,
            attitude=self.pose.orientation,
            angular_velocity=self.twist.angular,
        )
