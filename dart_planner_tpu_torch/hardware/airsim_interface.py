"""AirSim vehicle interface, import-gated (PyTorch counterpart of
:mod:`dart_planner_tpu.hardware.airsim_interface`).

Parity port of the reference ``AirSimDroneInterface``
(the reference's hardware/airsim_interface.py:30-380, "AS")
and its VehicleIO adapter (airsim_adapter.py): RPC connect/arm/API-control,
state polling into :class:`DroneState`, thrust/torque → AirSim
``moveByMotorPWMsAsync``-style commands, takeoff/land/emergency, pause /
resume, and performance metrics with bounded history
(hardware/metrics.py:18-44 — here :class:`MetricsManager`).

The polled ``DroneState`` lives on ``device`` (a keyword, default: the
card): the 13 numbers of a poll are packed into one float32 host array and
copied to the device once, so the state on the card equals the CPU's bit
for bit. A command's thrust and torque are read to the host once. The
client is injectable (``client=`` arg) so tests drive the full surface
with a mock; constructing without it where the ``airsim`` RPC package is
not installed raises :class:`HardwareError`. Registered as ``"airsim"`` in
:class:`VehicleIOFactory`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from dart_planner_tpu_torch.common.device import resolve_device, to_host
from dart_planner_tpu_torch.common.errors import HardwareError
from dart_planner_tpu_torch.common.metrics import MetricsManager
from dart_planner_tpu_torch.common.types import ControlCommand, DroneState, Trajectory
from dart_planner_tpu_torch.hardware.vehicle_io import VehicleIO, VehicleIOFactory

try:  # pragma: no cover - optional dependency
    import airsim as _airsim

    _HAS_AIRSIM = True
except ImportError:
    _airsim = None
    _HAS_AIRSIM = False


@dataclass
class AirSimConfig:
    """(AS AirSimConfig; defaults mirror the reference's SimpleFlight setup)."""

    ip: str = "127.0.0.1"
    port: int = 41451
    vehicle_name: str = ""
    timeout_s: float = 10.0
    control_frequency: float = 400.0
    max_velocity: float = 15.0
    takeoff_altitude: float = 2.0


class AirSimDroneInterface:
    """Async facade over the AirSim RPC client (AS:30-380)."""

    def __init__(
        self,
        config: Optional[AirSimConfig] = None,
        client: Optional[Any] = None,
        device=None,
    ):
        self.config = config or AirSimConfig()
        if client is not None:
            self._client = client
        elif _HAS_AIRSIM:  # pragma: no cover
            self._client = _airsim.MultirotorClient(
                ip=self.config.ip, port=self.config.port
            )
        else:
            raise HardwareError(
                "airsim package not available; inject a client= for tests"
            )
        self.device = resolve_device(device)
        self.metrics = MetricsManager()
        self._connected = False
        self._armed = False
        self._api_control = False

    # -- lifecycle (AS:55-66) --
    async def connect(self) -> bool:
        try:
            self._client.confirmConnection()
            self._client.enableApiControl(True, self.config.vehicle_name)
            self._api_control = True
            self._connected = True
            return True
        except Exception as exc:
            self.metrics.increment("connection_errors")
            raise HardwareError(f"AirSim connection failed: {exc}") from exc

    async def disconnect(self) -> None:
        if self._connected:
            try:
                self._client.enableApiControl(False, self.config.vehicle_name)
            finally:
                self._api_control = False
                self._connected = False

    # -- state (AS:68-107) --
    async def get_state(self) -> DroneState:
        t0 = time.perf_counter()
        ks = self._client.getMultirotorState(self.config.vehicle_name)
        kin = ks.kinematics_estimated
        # AirSim is NED; convert to the framework's ENU convention
        # (common/frames.py): (n, e, d) -> (e, n, -d)
        p = kin.position
        v = kin.linear_velocity
        w = kin.angular_velocity
        att = _ned_euler_to_enu(_quat_to_euler(kin.orientation))
        # float32 on the host, as DroneState.create rounds each field, then
        # one copy to the device
        row = np.array(
            [time.time(), p.y_val, p.x_val, -p.z_val, v.y_val, v.x_val, -v.z_val,
             *att, w.y_val, w.x_val, -w.z_val],
            np.float32,
        )
        packed = torch.from_numpy(row).to(self.device)
        state = DroneState(
            timestamp=packed[0],
            position=packed[1:4],
            velocity=packed[4:7],
            attitude=packed[7:10],
            angular_velocity=packed[10:13],
        )
        self.metrics.record("state_poll_ms", (time.perf_counter() - t0) * 1e3)
        return state

    # -- commands (AS:109-197) --
    async def send_control_command(self, command: ControlCommand) -> bool:
        if not (self._connected and self._api_control):
            self.metrics.increment("command_rejected")
            return False
        t0 = time.perf_counter()
        try:
            # thrust and torque read to the host at once
            wrench = to_host(torch.cat([
                torch.as_tensor(command.thrust, dtype=torch.float32).reshape(1),
                torch.as_tensor(command.torque, dtype=torch.float32).reshape(3),
            ]))
            thrust, torque = float(wrench[0]), wrench[1:]
            # normalized rates proxy (AS maps thrust/torque onto
            # moveByAngleRatesThrottleAsync in SimpleFlight)
            throttle = float(np.clip(thrust / 20.0, 0.0, 1.0))
            self._client.moveByAngleRatesThrottleAsync(
                float(torque[0]),
                float(torque[1]),
                float(torque[2]),
                throttle,
                1.0 / self.config.control_frequency,
                self.config.vehicle_name,
            )
            self.metrics.record(
                "command_latency_ms", (time.perf_counter() - t0) * 1e3
            )
            self.metrics.increment("commands_sent")
            return True
        except Exception:
            self.metrics.increment("command_errors")
            return False

    async def takeoff(self, altitude: Optional[float] = None) -> bool:
        alt = altitude if altitude is not None else self.config.takeoff_altitude
        self._client.armDisarm(True, self.config.vehicle_name)
        self._armed = True
        self._client.takeoffAsync(
            timeout_sec=self.config.timeout_s,
            vehicle_name=self.config.vehicle_name,
        ).join()
        self._client.moveToZAsync(
            -abs(alt), 1.0, vehicle_name=self.config.vehicle_name
        ).join()
        return True

    async def land(self) -> bool:
        self._client.landAsync(
            timeout_sec=self.config.timeout_s,
            vehicle_name=self.config.vehicle_name,
        ).join()
        self._client.armDisarm(False, self.config.vehicle_name)
        self._armed = False
        return True

    async def emergency_land(self) -> None:
        self.metrics.increment("emergency_stops")
        try:
            self._client.hoverAsync(self.config.vehicle_name)
        finally:
            await self.land()

    async def pause(self) -> bool:
        self._client.simPause(True)
        return True

    async def resume(self) -> bool:
        self._client.simPause(False)
        return True

    # -- metrics (AS:239-264) --
    def get_performance_metrics(self) -> Dict[str, Any]:
        return self.metrics.all_summaries()

    def reset_metrics(self) -> None:
        self.metrics.reset()

    @property
    def connected(self) -> bool:
        return self._connected

    @property
    def armed(self) -> bool:
        return self._armed

    @property
    def api_control_enabled(self) -> bool:
        return self._api_control


def _ned_euler_to_enu(att_ned: tuple) -> tuple:
    """NED roll/pitch/yaw -> ENU: roll unchanged, pitch negated, and
    yaw_enu = pi/2 - yaw_ned (east-facing = 0 in ENU), wrapped to
    (-pi, pi]. Positions/velocities are converted separately; without
    this the attitude would stay in NED and lateral acceleration
    commands would be rotated ~90 degrees."""
    roll, pitch, yaw = att_ned
    yaw_enu = np.pi / 2.0 - yaw
    yaw_enu = float(np.arctan2(np.sin(yaw_enu), np.cos(yaw_enu)))
    return roll, -pitch, yaw_enu


def _quat_to_euler(q) -> tuple:
    """AirSim quaternion (w,x,y,z) -> roll/pitch/yaw."""
    w, x, y, z = q.w_val, q.x_val, q.y_val, q.z_val
    roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = np.arcsin(np.clip(2 * (w * y - z * x), -1.0, 1.0))
    yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return float(roll), float(pitch), float(yaw)


class AirSimVehicleIO(VehicleIO):
    """VehicleIO adapter over :class:`AirSimDroneInterface`
    (reference airsim_adapter.py)."""

    def __init__(
        self, config: Optional[dict] = None, client: Optional[Any] = None, device=None
    ):
        super().__init__(config)
        cfg = AirSimConfig(**(config or {}))
        self.iface = AirSimDroneInterface(cfg, client=client, device=device)
        self.device = self.iface.device
        self._last_state: Optional[DroneState] = None
        self._trajectory: Optional[Trajectory] = None

    async def connect(self) -> bool:
        return await self.iface.connect()

    async def disconnect(self) -> None:
        await self.iface.disconnect()

    def get_state(self) -> Optional[DroneState]:
        return self._last_state

    async def poll_state(self) -> DroneState:
        self._last_state = await self.iface.get_state()
        return self._last_state

    async def send_trajectory(self, trajectory: Trajectory) -> bool:
        self._trajectory = trajectory
        return True

    async def arm(self) -> bool:
        self.iface._client.armDisarm(True, self.iface.config.vehicle_name)
        self.iface._armed = True
        return True

    async def disarm(self) -> bool:
        self.iface._client.armDisarm(False, self.iface.config.vehicle_name)
        self.iface._armed = False
        return True

    async def takeoff(self, altitude: float) -> bool:
        return await self.iface.takeoff(altitude)

    async def land(self) -> bool:
        return await self.iface.land()

    async def emergency_stop(self) -> None:
        await self.iface.emergency_land()

    def get_status(self) -> Dict[str, Any]:
        return {
            "connected": self.iface.connected,
            "armed": self.iface.armed,
            "api_control": self.iface.api_control_enabled,
            "metrics": self.iface.get_performance_metrics(),
        }


VehicleIOFactory.register("airsim", AirSimVehicleIO)
