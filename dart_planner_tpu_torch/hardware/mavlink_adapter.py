"""MAVLink/Pixhawk vehicle adapter, import-gated (PyTorch counterpart of
:mod:`dart_planner_tpu.hardware.mavlink_adapter`).

API-parity port of the reference ``PixhawkInterface``
(the reference's hardware/pixhawk_interface.py, "PX"): connection +
heartbeat wait (PX:127-158), data-stream requests at control rate
(PX:167-186), mode/arm/takeoff/land with COMMAND_ACK handling
(PX:188-291), body-rate offboard targets (PX:372-420), and the four-loop
mission structure (control/planning/telemetry/safety, PX:297-314) — here
exposed as a VehicleIO adapter whose mission loops live in
:mod:`dart_planner_tpu_torch.hardware.mission`: the runner's smoother and
geometric controller run on the runner's device and hand this adapter a
body-rate target each control tick.

The adapter's ``DroneState`` lives on ``device`` (default: the card). A
poll packs the 13 numbers it drained (time, position, velocity, attitude,
rates) into one host array and copies it to the device once; a body-rate
target is read to the host once. Without ``pymavlink``, constructing the
adapter raises :class:`HardwareError` unless a ``mavutil`` stand-in is
injected (the tests' scripted link).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from dart_planner_tpu_torch.common.device import resolve_device, to_host
from dart_planner_tpu_torch.common.errors import HardwareError
from dart_planner_tpu_torch.common.types import BodyRateCommand, DroneState, Trajectory
from dart_planner_tpu_torch.hardware.vehicle_io import VehicleIO, VehicleIOFactory

try:  # pragma: no cover - optional dependency
    from pymavlink import mavutil as _mavutil

    _HAS_MAVLINK = True
except ImportError:
    _mavutil = None
    _HAS_MAVLINK = False


@dataclass
class MavlinkConfig:
    """(PX HardwareConfig:22-47)"""

    connection_string: str = "/dev/ttyUSB0"
    baud_rate: int = 921600
    control_frequency: float = 400.0
    planning_frequency: float = 50.0
    telemetry_frequency: float = 10.0
    heartbeat_timeout_s: float = 5.0
    planning_warning_ms: float = 8.0


class MavlinkVehicleIO(VehicleIO):
    """(PX:50-765 as a VehicleIO adapter; reference pixhawk_adapter.py)"""

    def __init__(self, config: Optional[dict] = None, mavutil: Any = None, device=None):
        super().__init__(config)
        self._mavutil = mavutil if mavutil is not None else _mavutil
        if self._mavutil is None:
            raise HardwareError(
                "pymavlink is not installed; MavlinkVehicleIO requires it "
                "(inject a mock `mavutil` for testing)"
            )
        self.device = resolve_device(device)
        cfg = config or {}
        self.mav_config = MavlinkConfig(
            connection_string=cfg.get("connection_string", "/dev/ttyUSB0"),
            baud_rate=cfg.get("baud_rate", 921600),
        )
        self._conn: Any = None
        self._last_state: Optional[DroneState] = None
        self._last_heartbeat = 0.0

    async def connect(self) -> bool:
        """Connect + wait for heartbeat (PX:127-158)."""
        self._conn = self._mavutil.mavlink_connection(
            self.mav_config.connection_string, baud=self.mav_config.baud_rate
        )
        hb = self._conn.wait_heartbeat(
            timeout=self.mav_config.heartbeat_timeout_s
        )
        if hb is None:
            raise HardwareError("no MAVLink heartbeat")
        self._last_heartbeat = time.time()
        self._request_data_streams()
        self.connected = True
        return True

    def _request_data_streams(self) -> None:
        """Stream requests at control rate (PX:167-186)."""
        self._conn.mav.request_data_stream_send(
            self._conn.target_system,
            self._conn.target_component,
            0,  # MAV_DATA_STREAM_ALL
            int(self.mav_config.control_frequency),
            1,
        )

    async def disconnect(self) -> None:
        if self._conn is not None:
            self._conn.close()
        self.connected = False

    def poll_state(self) -> Optional[DroneState]:
        """Drain LOCAL_POSITION_NED / ATTITUDE into a DroneState
        (PX telemetry path; state_estimation/px4_ekf2.py)."""
        if self._conn is None:
            return self._last_state
        pos = vel = att = rates = None
        while True:
            msg = self._conn.recv_match(blocking=False)
            if msg is None:
                break
            t = msg.get_type()
            if t == "LOCAL_POSITION_NED":
                pos = (msg.x, msg.y, -msg.z)  # NED -> ENU z
                vel = (msg.vx, msg.vy, -msg.vz)
            elif t == "ATTITUDE":
                att = (msg.roll, msg.pitch, msg.yaw)
                rates = (msg.rollspeed, msg.pitchspeed, msg.yawspeed)
            elif t == "HEARTBEAT":
                self._last_heartbeat = time.time()
        if pos is not None:
            zero = (0.0, 0.0, 0.0)
            # float32 on the host, as DroneState.create rounds each field,
            # then one copy to the device
            row = np.array(
                [time.time(), *pos, *(vel or zero), *(att or zero), *(rates or zero)],
                np.float32,
            )
            packed = torch.from_numpy(row).to(self.device)
            self._last_state = DroneState(
                timestamp=packed[0],
                position=packed[1:4],
                velocity=packed[4:7],
                attitude=packed[7:10],
                angular_velocity=packed[10:13],
            )
        return self._last_state

    def get_state(self) -> Optional[DroneState]:
        return self.poll_state()

    def send_body_rate_target(self, cmd: BodyRateCommand) -> None:
        """SET_ATTITUDE_TARGET with body rates (PX:372-420); the target is
        read to the host once."""
        rates_thrust = to_host(torch.cat([cmd.body_rates.reshape(3), cmd.thrust.reshape(1)]))
        self._conn.mav.set_attitude_target_send(
            0,
            self._conn.target_system,
            self._conn.target_component,
            0b10000000,  # ignore attitude quaternion, use rates
            [1.0, 0.0, 0.0, 0.0],
            *(float(x) for x in rates_thrust),
        )

    async def send_trajectory(self, trajectory: Trajectory) -> bool:
        # the mission runner's 400 Hz loop converts trajectories to
        # body-rate targets; direct trajectory upload is not a PX4
        # offboard concept
        return True

    async def _command_long(self, command: int, *params: float) -> bool:
        """COMMAND_LONG + ACK wait (PX:188-291)."""
        self._conn.mav.command_long_send(
            self._conn.target_system,
            self._conn.target_component,
            command,
            0,
            *(list(params) + [0.0] * (7 - len(params))),
        )
        ack = self._conn.recv_match(
            type="COMMAND_ACK", blocking=True, timeout=3.0
        )
        return ack is not None and ack.result == 0

    async def arm(self) -> bool:
        self.armed = await self._command_long(400, 1.0)  # MAV_CMD_COMPONENT_ARM_DISARM
        return self.armed

    async def disarm(self) -> bool:
        ok = await self._command_long(400, 0.0)
        self.armed = False
        return ok

    async def takeoff(self, altitude: float) -> bool:
        return await self._command_long(22, 0, 0, 0, 0, 0, 0, altitude)  # NAV_TAKEOFF

    async def land(self) -> bool:
        return await self._command_long(21)  # MAV_CMD_NAV_LAND

    async def emergency_stop(self) -> None:
        await self._command_long(400, 0.0, 21196.0)  # force disarm magic

    def heartbeat_age(self) -> float:
        return time.time() - self._last_heartbeat


if _HAS_MAVLINK:  # pragma: no cover
    VehicleIOFactory.register("pixhawk", MavlinkVehicleIO)
