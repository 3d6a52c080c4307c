"""Motor mixing: wrench -> per-motor PWM.

A framework-free copy of :mod:`dart_planner_tpu.hardware.motor_mixer`: the port keeps its own,
since the JAX package cannot be imported without jax.

Port of the reference ``hardware/motor_mixer.py`` ("MX"): geometry-derived
4x4 mixing matrix mapping [T, tau_x, tau_y, tau_z] -> motor thrusts
(MX:82-107), inverse via solve/pinv (MX:152-166), physics-based
thrust->PWM through the motor model (MX:224), saturation with event
counting and idle-fault detection (MX:168-260), and x/plus factory
helpers (MX:401-447). The allocation math is plain numpy (4x4, host
side); for batched fleets use ``allocate_batch`` which does the same
matrix ops over leading dims.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np

from dart_planner_tpu_torch.hardware.motor_model import (
    QuadraticMotorModel,
    create_default_motor_model,
)


@dataclass
class MotorMixingConfig:
    """(MX:40-107)"""

    motor_positions: List[List[float]] = field(
        default_factory=lambda: [
            [0.15, 0.15, 0.0],  # front-right
            [-0.15, 0.15, 0.0],  # front-left
            [-0.15, -0.15, 0.0],  # rear-left
            [0.15, -0.15, 0.0],  # rear-right
        ]
    )
    motor_directions: List[int] = field(default_factory=lambda: [1, -1, 1, -1])
    pwm_min: float = 0.0
    pwm_max: float = 1.0
    pwm_idle: float = 0.1
    arm_length: float = 0.15
    yaw_torque_coefficient: float = 0.05  # N m of drag torque per N of thrust
    motor_model: Any = None


def mixing_matrix_from_geometry(config: MotorMixingConfig) -> np.ndarray:
    """Rows = motors, columns = [thrust, tau_x, tau_y, tau_z] contribution
    (MX:82-107). tau_x = sum F_i * y_i, tau_y = sum F_i * (-x_i) (nose-up
    positive), tau_z = sum dir_i * k_drag * F_i."""
    B = np.zeros((4, 4))
    for i, (pos, d) in enumerate(
        zip(config.motor_positions, config.motor_directions)
    ):
        x, y, _ = pos
        B[i, 0] = 1.0
        B[i, 1] = y
        B[i, 2] = -x
        B[i, 3] = d * config.yaw_torque_coefficient
    return B


class MotorMixer:
    """(MX:110-447)"""

    def __init__(self, config: Optional[MotorMixingConfig] = None):
        self.config = config or MotorMixingConfig()
        self.motor_model: QuadraticMotorModel = (
            self.config.motor_model or create_default_motor_model()
        )
        # mixing matrix maps motor thrusts -> wrench; allocation inverts it
        self.mixing_matrix = mixing_matrix_from_geometry(self.config)
        try:
            # wrench w = B^T f  =>  f = (B^T)^{-1} w
            self.inverse_matrix = np.linalg.solve(self.mixing_matrix.T, np.eye(4))
        except np.linalg.LinAlgError:
            self.inverse_matrix = np.linalg.pinv(self.mixing_matrix.T)
        self.saturation_events = 0
        self.idle_faults = 0
        self.last_motor_pwms = np.zeros(4)

    def allocate_thrusts(self, thrust: float, torque: np.ndarray) -> np.ndarray:
        """Wrench -> per-motor thrusts (N): solve B^T f = w (MX:152-166)."""
        wrench = np.concatenate([[thrust], np.asarray(torque, dtype=float)])
        return self.inverse_matrix @ wrench

    def mix_commands(self, thrust: float, torque: np.ndarray) -> np.ndarray:
        """Wrench -> normalized PWM with saturation accounting (MX:168-260)."""
        f = self.allocate_thrusts(thrust, torque)
        # negative allocations = infeasible wrench; clamp and count
        if np.any(f < -1e-9):
            self.idle_faults += 1
        f = np.maximum(f, 0.0)
        # saturation: demanded thrust beyond what pwm_max can produce
        f_max = self.motor_model.thrust_from_pwm(self.config.pwm_max)
        if np.any(f > f_max + 1e-9):
            self.saturation_events += 1
        pwm = self.motor_model.pwm_from_thrust(f)
        pwm = np.clip(pwm, self.config.pwm_idle, self.config.pwm_max)
        self.last_motor_pwms = pwm
        return pwm

    def wrench_from_thrusts(self, motor_thrusts: np.ndarray) -> np.ndarray:
        """Forward map for verification: motor thrusts -> [T, tau]."""
        return self.mixing_matrix.T @ np.asarray(motor_thrusts, dtype=float)

    def allocate_batch(self, thrust: np.ndarray, torque: np.ndarray) -> np.ndarray:
        """Batched allocation: (..., ) thrust + (..., 3) torque -> (..., 4)."""
        w = np.concatenate([thrust[..., None], torque], axis=-1)
        return np.einsum("mk,...k->...m", self.inverse_matrix, w)

    def validate_configuration(self) -> List[str]:
        """(MX:340-398)"""
        issues = []
        if len(self.config.motor_positions) != 4:
            issues.append("expected 4 motor positions")
        if abs(np.linalg.det(self.mixing_matrix)) < 1e-9:
            issues.append("mixing matrix is singular")
        if sum(self.config.motor_directions) != 0:
            issues.append("spin directions must cancel for yaw authority")
        return issues

    def get_status(self) -> dict:
        return {
            "saturation_events": self.saturation_events,
            "idle_faults": self.idle_faults,
            "last_motor_pwms": self.last_motor_pwms.tolist(),
        }


def create_x_configuration(arm_length: float = 0.15) -> MotorMixingConfig:
    """X quad (MX:401-424)."""
    a = arm_length / np.sqrt(2)
    return MotorMixingConfig(
        motor_positions=[
            [a, a, 0.0],
            [-a, a, 0.0],
            [-a, -a, 0.0],
            [a, -a, 0.0],
        ],
        motor_directions=[1, -1, 1, -1],
        arm_length=arm_length,
    )


def create_plus_configuration(arm_length: float = 0.15) -> MotorMixingConfig:
    """Plus quad (MX:427-447)."""
    return MotorMixingConfig(
        motor_positions=[
            [arm_length, 0.0, 0.0],
            [0.0, arm_length, 0.0],
            [-arm_length, 0.0, 0.0],
            [0.0, -arm_length, 0.0],
        ],
        motor_directions=[1, -1, 1, -1],
        arm_length=arm_length,
    )
