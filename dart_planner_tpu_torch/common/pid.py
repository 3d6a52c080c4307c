"""Vector PID controller.

A framework-free copy of :mod:`dart_planner_tpu.common.pid`: the port keeps its own,
since the JAX package cannot be imported without jax.

Re-design of the reference scalar ``PIDController``
(the reference's utils/pid_controller.py): instead of six
independent scalar objects per controller (reference
onboard_controller.py:30-35), one :class:`VectorPID` handles an arbitrary
(...,) array of channels in a single numpy/jax-compatible update — gains,
integral limits, and setpoints are all arrays broadcast against the state.
"""

from __future__ import annotations

import numpy as np


class VectorPID:
    """PID over an array of channels: ``u = kp e + ki ∫e dt + kd de/dt``.

    Anti-windup by integral clamping (``integral_limit``); derivative on
    error with first-sample suppression. Shapes of ``kp/ki/kd`` define the
    channel layout and everything broadcasts against it.
    """

    def __init__(self, kp, ki=0.0, kd=0.0, integral_limit=np.inf, setpoint=0.0):
        self.kp = np.asarray(kp, np.float64)
        self.ki = np.broadcast_to(np.asarray(ki, np.float64), self.kp.shape).copy()
        self.kd = np.broadcast_to(np.asarray(kd, np.float64), self.kp.shape).copy()
        self.integral_limit = np.broadcast_to(
            np.asarray(integral_limit, np.float64), self.kp.shape
        ).copy()
        self.setpoint = np.broadcast_to(
            np.asarray(setpoint, np.float64), self.kp.shape
        ).copy()
        self.reset()

    def reset(self) -> None:
        self._integral = np.zeros_like(self.kp)
        self._prev_error = None

    def update(self, measurement, dt: float) -> np.ndarray:
        """One PID step; returns the control output array."""
        error = self.setpoint - np.asarray(measurement, np.float64)
        if dt <= 0.0:
            return self.kp * error
        self._integral = np.clip(
            self._integral + error * dt,
            -self.integral_limit,
            self.integral_limit,
        )
        if self._prev_error is None:
            derivative = np.zeros_like(error)
        else:
            derivative = (error - self._prev_error) / dt
        self._prev_error = error
        return self.kp * error + self.ki * self._integral + self.kd * derivative
