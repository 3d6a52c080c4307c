"""Estimator adapters -> EstimatedState (PyTorch counterpart of
:mod:`dart_planner_tpu.estimation.adapters`).

Port of the reference ``state_estimation/px4_ekf2.py`` (MAVLink EKF2
consumer; :23-84) and ``airsim_shim.py`` (ground-truth shim). Unit-safe at
the boundary: raw MAVLink fields are converted to SI here, never inside
hot loops.
"""

from __future__ import annotations

import time
from typing import Any, Optional

import numpy as np
import torch

from dart_planner_tpu_torch.common.device import resolve_device
from dart_planner_tpu_torch.common.types import Accel, DroneState, EstimatedState, Pose, Twist


class PX4EKF2StateEstimator:
    """(reference px4_ekf2.py:7-86); the estimate's tensors go to
    ``device`` (default: the card)."""

    def __init__(self, mavlink_connection: Any, device=None):
        self.conn = mavlink_connection
        self.device = resolve_device(device)
        self._latest: Optional[EstimatedState] = None

    def _v3(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def update(self) -> None:
        """Drain ATTITUDE / GLOBAL_POSITION_INT / ODOMETRY messages."""
        now = time.time()
        pos = vel = att = rates = None
        while True:
            msg = self.conn.recv_match(
                type=["ATTITUDE", "GLOBAL_POSITION_INT", "ODOMETRY"],
                blocking=False,
            )
            if not msg:
                break
            t = msg.get_type()
            if t == "ATTITUDE":
                att = [msg.roll, msg.pitch, msg.yaw]  # rad (MAVLink spec)
                rates = [msg.rollspeed, msg.pitchspeed, msg.yawspeed]
            elif t == "GLOBAL_POSITION_INT":
                lat_deg = msg.lat / 1e7
                lon_deg = msg.lon / 1e7
                # flat-earth local meters with cos(lat) easting
                # (reference px4_ekf2.py:50-59)
                north = lat_deg * 111320.0
                east = lon_deg * 111320.0 * np.cos(np.deg2rad(lat_deg))
                pos = [north, east, msg.alt / 1e3]
                vel = [msg.vx / 100.0, msg.vy / 100.0, msg.vz / 100.0]
            elif t == "ODOMETRY":
                pos = [msg.x, msg.y, msg.z]
                att = [msg.roll, msg.pitch, msg.yaw]
                vel = [msg.vx, msg.vy, msg.vz]
                rates = [msg.rollspeed, msg.pitchspeed, msg.yawspeed]
        if pos is None and att is None:
            return
        z3 = torch.zeros(3, dtype=torch.float32, device=self.device)
        self._latest = EstimatedState(
            timestamp=torch.tensor(now, dtype=torch.float32, device=self.device),
            pose=Pose(
                position=self._v3(pos) if pos is not None else z3,
                orientation=self._v3(att) if att is not None else z3,
            ),
            twist=Twist(
                linear=self._v3(vel) if vel is not None else z3,
                angular=self._v3(rates) if rates is not None else z3,
            ),
            accel=Accel(linear=z3, angular=z3),
            source="PX4_EKF2",
        )

    def get_latest(self) -> Optional[EstimatedState]:
        return self._latest


class SimGroundTruthEstimator:
    """Ground-truth shim (reference airsim_shim.py): wraps any object with
    a ``get_state() -> DroneState`` into the estimator interface, on the
    state's own device."""

    def __init__(self, vehicle: Any):
        self.vehicle = vehicle
        self._latest: Optional[EstimatedState] = None

    def update(self) -> None:
        state: Optional[DroneState] = self.vehicle.get_state()
        if state is None:
            return
        z3 = torch.zeros_like(state.position)
        self._latest = EstimatedState(
            timestamp=state.timestamp,
            pose=Pose(position=state.position, orientation=state.attitude),
            twist=Twist(linear=state.velocity, angular=state.angular_velocity),
            accel=Accel(linear=z3, angular=z3),
            source="sim_ground_truth",
        )

    def get_latest(self) -> Optional[EstimatedState]:
        return self._latest
