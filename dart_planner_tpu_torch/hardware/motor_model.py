"""Physics-based motor models.

A framework-free copy of :mod:`dart_planner_tpu.hardware.motor_model`: the port keeps its own,
since the JAX package cannot be imported without jax.

Port of the reference ``hardware/motor_model.py`` ("MM"): quadratic
thrust = a*pwm^2 + b*pwm + c per motor (MM:139-317), bench-data fitting
(MM:319-384), default model (MM:386-433). Vectorized: all per-motor
curves are arrays, so thrust/pwm conversions work on whole motor banks
(and batches of vehicles) at once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from dart_planner_tpu_torch.common.errors import HardwareError


@dataclass(frozen=True)
class MotorParameters:
    """Per-motor quadratic curve coefficients (MM:28-71)."""

    thrust_a: float  # N per pwm^2
    thrust_b: float  # N per pwm
    thrust_c: float  # N offset
    torque_a: float = 0.0  # N m per pwm^2
    torque_b: float = 0.0
    torque_c: float = 0.0
    max_rpm: float = 10000.0
    pwm_min: float = 0.0
    pwm_max: float = 1.0


class QuadraticMotorModel:
    """(MM:139-317) thrust(pwm) = a pwm^2 + b pwm + c, invertible."""

    def __init__(self, motor_parameters: Dict[int, MotorParameters]):
        if not motor_parameters:
            raise HardwareError("motor model needs at least one motor")
        self.params = motor_parameters
        ids = sorted(motor_parameters)
        self._a = np.array([motor_parameters[i].thrust_a for i in ids])
        self._b = np.array([motor_parameters[i].thrust_b for i in ids])
        self._c = np.array([motor_parameters[i].thrust_c for i in ids])
        self._ids = ids

    def thrust_from_pwm(self, pwm, motor_id: Optional[int] = None):
        """(MM:166-190); with ``motor_id=None`` maps a whole bank."""
        pwm = np.asarray(pwm)
        if motor_id is not None:
            p = self.params[motor_id]
            return p.thrust_a * pwm**2 + p.thrust_b * pwm + p.thrust_c
        return self._a * pwm**2 + self._b * pwm + self._c

    def pwm_from_thrust(self, thrust, motor_id: Optional[int] = None):
        """Inverse via the positive quadratic root (MM:219-258)."""
        thrust = np.asarray(thrust, dtype=float)
        if motor_id is not None:
            a, b, c = (
                self.params[motor_id].thrust_a,
                self.params[motor_id].thrust_b,
                self.params[motor_id].thrust_c,
            )
        else:
            a, b, c = self._a, self._b, self._c
        # a pwm^2 + b pwm + (c - thrust) = 0
        disc = np.maximum(b**2 - 4 * a * (c - thrust), 0.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            quad = (-b + np.sqrt(disc)) / (2 * a)
            lin = (thrust - c) / np.where(np.abs(b) > 1e-12, b, np.inf)
        pwm = np.where(np.abs(np.asarray(a)) > 1e-12, quad, lin)
        return np.clip(pwm, 0.0, 1.0)

    def torque_from_pwm(self, pwm, motor_id: int):
        """(MM:192-217)"""
        p = self.params[motor_id]
        pwm = np.asarray(pwm)
        return p.torque_a * pwm**2 + p.torque_b * pwm + p.torque_c

    def rpm_from_pwm(self, pwm, motor_id: int):
        """Linear RPM map (MM:260-282)."""
        return np.asarray(pwm) * self.params[motor_id].max_rpm

    def get_motor_parameters(self, motor_id: int) -> MotorParameters:
        return self.params[motor_id]

    def validate_pwm(self, pwm, motor_id: int) -> bool:
        p = self.params[motor_id]
        return bool(np.all((np.asarray(pwm) >= p.pwm_min) & (np.asarray(pwm) <= p.pwm_max)))


@dataclass
class BenchTestData:
    """Bench measurement set for one motor (MM:73-103)."""

    pwm_values: Sequence[float]
    thrust_values: Sequence[float]  # N
    torque_values: Optional[Sequence[float]] = None
    motor_id: int = 0

    def validate(self) -> List[str]:
        issues = []
        if len(self.pwm_values) != len(self.thrust_values):
            issues.append("pwm/thrust length mismatch")
        if len(self.pwm_values) < 3:
            issues.append("need >= 3 samples for a quadratic fit")
        if any(not 0 <= p <= 1 for p in self.pwm_values):
            issues.append("pwm out of [0, 1]")
        return issues


def fit_quadratic_motor_model(
    bench_data: Sequence[BenchTestData],
) -> QuadraticMotorModel:
    """Least-squares quadratic fit per motor (MM:319-384)."""
    params: Dict[int, MotorParameters] = {}
    for data in bench_data:
        issues = data.validate()
        if issues:
            raise HardwareError(f"bad bench data for motor {data.motor_id}: {issues}")
        ta, tb, tc = np.polyfit(data.pwm_values, data.thrust_values, 2)
        if data.torque_values is not None:
            qa, qb, qc = np.polyfit(data.pwm_values, data.torque_values, 2)
        else:
            qa = qb = qc = 0.0
        params[data.motor_id] = MotorParameters(
            thrust_a=float(ta),
            thrust_b=float(tb),
            thrust_c=float(tc),
            torque_a=float(qa),
            torque_b=float(qb),
            torque_c=float(qc),
        )
    return QuadraticMotorModel(params)


def create_default_motor_model(num_motors: int = 4) -> QuadraticMotorModel:
    """Default curves matching a ~12 N motor (MM:386-433): thrust(1.0)=12 N,
    mildly quadratic, small idle offset."""
    p = MotorParameters(thrust_a=8.0, thrust_b=4.0, thrust_c=0.0)
    return QuadraticMotorModel({i: p for i in range(num_motors)})
