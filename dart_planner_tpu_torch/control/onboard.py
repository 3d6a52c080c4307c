"""Legacy onboard cascaded-PID controller (PyTorch counterpart of
:mod:`dart_planner_tpu.control.onboard`: numpy over the port's types; the
state and plan are copied to the host, the command is made on the state's
device).

Parity port of the reference ``OnboardController``
(the reference's control/onboard_controller.py:18-193),
the simple edge-side controller used by the legacy edge main: trajectory
interpolation → position PID → small-angle attitude inversion → inner
attitude PID → thrust/torque command. Where the reference runs six scalar
PID objects, this uses two :class:`~dart_planner_tpu_torch.common.pid.VectorPID`
banks (position xyz; roll/pitch/yaw-rate). The production path is
:mod:`dart_planner_tpu_torch.control.geometric` — this exists for API parity and
as the degraded-mode fallback controller.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from dart_planner_tpu_torch.common.device import to_host
from dart_planner_tpu_torch.common.pid import VectorPID
from dart_planner_tpu_torch.common.types import ControlCommand, DroneState, Trajectory


def _command(thrust, torque, like: torch.Tensor) -> ControlCommand:
    """float32 command tensors on ``like``'s device."""
    return ControlCommand(
        thrust=torch.tensor(thrust, dtype=torch.float32, device=like.device),
        torque=torch.as_tensor(
            np.asarray(torque, np.float32), device=like.device
        ),
    )


class OnboardController:
    """Feedforward + cascaded-PID fallback controller."""

    def __init__(self, mass: float = 1.0, g: float = 9.81) -> None:
        self.mass = mass
        self.g = g
        # position PID bank (reference onboard_controller.py:30-32)
        self.pos_pid = VectorPID(
            kp=[10.0, 10.0, 12.0],
            ki=[1.0, 1.0, 1.5],
            kd=[5.0, 5.0, 6.0],
            integral_limit=2.0,
        )
        # inner bank: roll, pitch (attitude) + yaw rate (:33-35)
        self.att_pid = VectorPID(
            kp=[8.0, 8.0, 4.0],
            ki=0.0,
            kd=[2.0, 2.0, 1.0],
            integral_limit=[1.0, 1.0, 0.5],
        )
        self.last_time: Optional[float] = None

    # -- sense --------------------------------------------------------
    def _interpolate_trajectory(
        self, current_time: float, trajectory: Trajectory
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Linear interpolation of (pos, vel, acc) at ``current_time``
        (reference :43-93); clamps to the trajectory endpoints."""
        ts = to_host(trajectory.timestamps)
        pos = to_host(trajectory.positions)
        vel = (
            to_host(trajectory.velocities)
            if trajectory.velocities is not None
            else np.zeros_like(pos)
        )
        acc = (
            to_host(trajectory.accelerations)
            if trajectory.accelerations is not None
            else np.zeros_like(pos)
        )
        t = np.clip(current_time, ts[0], ts[-1])
        out = []
        for arr in (pos, vel, acc):
            out.append(
                np.stack(
                    [np.interp(t, ts, arr[:, d]) for d in range(arr.shape[1])]
                )
            )
        return out[0], out[1], out[2]

    def sense(
        self, current_state: DroneState, trajectory: Trajectory
    ) -> Tuple[float, np.ndarray, np.ndarray, np.ndarray]:
        now = float(to_host(current_state.timestamp))
        dt = now - self.last_time if self.last_time is not None else 0.01
        self.last_time = now
        tp, tv, ta = self._interpolate_trajectory(now, trajectory)
        return dt, tp, tv, ta

    # -- plan ---------------------------------------------------------
    def plan(
        self,
        current_state: DroneState,
        target_pos: np.ndarray,
        target_accel: np.ndarray,
        dt: float,
    ) -> Tuple[float, float, float]:
        """Position PID + feedforward → desired (roll, pitch, thrust)
        via small-angle inversion (reference :95-161)."""
        self.pos_pid.setpoint = np.asarray(target_pos, np.float64)
        corrective = self.pos_pid.update(
            to_host(current_state.position), dt
        )
        a_des = np.asarray(target_accel, np.float64) + corrective
        yaw = float(to_host(current_state.attitude)[2])
        thrust = max(0.0, self.mass * (a_des[2] + self.g))
        # small-angle flat-dynamics inversion (reference :104-113)
        sin_y, cos_y = np.sin(yaw), np.cos(yaw)
        roll = (a_des[0] * sin_y - a_des[1] * cos_y) / self.g
        pitch = (a_des[0] * cos_y + a_des[1] * sin_y) / self.g
        return float(roll), float(pitch), float(thrust)

    # -- act ----------------------------------------------------------
    def act(
        self,
        current_state: DroneState,
        desired_roll: float,
        desired_pitch: float,
        thrust: float,
        dt: float,
        target_yaw_rate: float = 0.0,
    ) -> ControlCommand:
        """Inner attitude/yaw-rate PID → torque (reference :115-170)."""
        self.att_pid.setpoint = np.array(
            [desired_roll, desired_pitch, target_yaw_rate], np.float64
        )
        att = to_host(current_state.attitude)
        omega_z = float(to_host(current_state.angular_velocity)[2])
        torque = self.att_pid.update(np.array([att[0], att[1], omega_z]), dt)
        return _command(np.float32(thrust), torque, current_state.position)

    def compute_control_command(
        self, current_state: DroneState, trajectory: Trajectory
    ) -> Tuple[ControlCommand, np.ndarray]:
        """sense → plan → act (reference :172-180)."""
        dt, target_pos, _, target_accel = self.sense(current_state, trajectory)
        if dt <= 0:
            # repeated/non-monotonic timestamp: hold hover, never cut motors
            return self.get_fallback_command(current_state), target_pos
        roll, pitch, thrust = self.plan(current_state, target_pos, target_accel, dt)
        return self.act(current_state, roll, pitch, thrust, dt), target_pos

    def get_fallback_command(self, current_state: DroneState) -> ControlCommand:
        """Hover hold (reference :182-184)."""
        return _command(
            np.float32(self.mass * self.g), np.zeros(3), current_state.position
        )

    def reset(self) -> None:
        self.pos_pid.reset()
        self.att_pid.reset()
        self.last_time = None
