"""Vehicle I/O abstraction + factory + safety adapter (PyTorch counterpart
of :mod:`dart_planner_tpu.hardware.vehicle_io`, over the port's types).

Port of the reference ``hardware/vehicle_io.py``: ``VehicleIO`` ABC
(:18-103), ``VehicleIOFactory`` registry (:114-136), and the
safety-validating wrapper (:139-208) that geofences every command.
"""

from __future__ import annotations

import abc
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from dart_planner_tpu_torch.common.errors import HardwareError, ValidationError
from dart_planner_tpu_torch.common.types import DroneState, Trajectory


class VehicleIO(abc.ABC):
    """(reference vehicle_io.py:18-103)"""

    def __init__(self, config: Optional[dict] = None):
        self.config = config or {}
        self.connected = False
        self.armed = False

    @abc.abstractmethod
    async def connect(self) -> bool: ...

    @abc.abstractmethod
    async def disconnect(self) -> None: ...

    @abc.abstractmethod
    def get_state(self) -> Optional[DroneState]: ...

    @abc.abstractmethod
    async def send_trajectory(self, trajectory: Trajectory) -> bool: ...

    @abc.abstractmethod
    async def arm(self) -> bool: ...

    @abc.abstractmethod
    async def disarm(self) -> bool: ...

    @abc.abstractmethod
    async def takeoff(self, altitude: float) -> bool: ...

    @abc.abstractmethod
    async def land(self) -> bool: ...

    @abc.abstractmethod
    async def emergency_stop(self) -> None: ...

    def get_status(self) -> Dict[str, Any]:
        return {"connected": self.connected, "armed": self.armed}


class VehicleIOFactory:
    """Named-adapter registry (reference vehicle_io.py:114-136)."""

    _registry: Dict[str, Callable[..., VehicleIO]] = {}

    @classmethod
    def register(cls, name: str, ctor: Callable[..., VehicleIO]) -> None:
        cls._registry[name] = ctor

    @classmethod
    def create(cls, name: str, config: Optional[dict] = None) -> VehicleIO:
        if name not in cls._registry:
            raise HardwareError(
                f"unknown vehicle type {name!r}; available: {sorted(cls._registry)}"
            )
        return cls._registry[name](config)

    @classmethod
    def list_available(cls) -> List[str]:
        return sorted(cls._registry)


class SafetyValidatedVehicleIO(VehicleIO):
    """Wraps any VehicleIO with command validation (reference :139-208):
    geofence radius / altitude ceiling / velocity envelope checks before
    anything reaches the vehicle."""

    def __init__(
        self,
        inner: VehicleIO,
        max_altitude: float = 50.0,
        safety_radius: float = 100.0,
        max_velocity: float = 15.0,
    ):
        super().__init__(inner.config)
        self.inner = inner
        self.max_altitude = max_altitude
        self.safety_radius = safety_radius
        self.max_velocity = max_velocity
        self.rejected_commands = 0

    def _validate_trajectory(self, trajectory: Trajectory) -> None:
        pos = trajectory.positions.detach().cpu().numpy()
        if not np.isfinite(pos).all():
            raise ValidationError("trajectory contains non-finite positions")
        if np.any(pos[..., 2] > self.max_altitude):
            raise ValidationError(
                f"trajectory exceeds altitude ceiling {self.max_altitude} m"
            )
        if np.any(np.linalg.norm(pos[..., :2], axis=-1) > self.safety_radius):
            raise ValidationError(
                f"trajectory leaves geofence radius {self.safety_radius} m"
            )
        if trajectory.velocities is not None:
            v = np.linalg.norm(trajectory.velocities.detach().cpu().numpy(), axis=-1)
            if np.any(v > self.max_velocity):
                raise ValidationError(
                    f"trajectory exceeds velocity envelope {self.max_velocity} m/s"
                )

    async def connect(self) -> bool:
        self.connected = await self.inner.connect()
        return self.connected

    async def disconnect(self) -> None:
        await self.inner.disconnect()
        self.connected = False

    def get_state(self) -> Optional[DroneState]:
        return self.inner.get_state()

    async def send_trajectory(self, trajectory: Trajectory) -> bool:
        try:
            self._validate_trajectory(trajectory)
        except ValidationError:
            self.rejected_commands += 1
            raise
        return await self.inner.send_trajectory(trajectory)

    async def arm(self) -> bool:
        self.armed = await self.inner.arm()
        return self.armed

    async def disarm(self) -> bool:
        ok = await self.inner.disarm()
        self.armed = False
        return ok

    async def takeoff(self, altitude: float) -> bool:
        if altitude > self.max_altitude:
            self.rejected_commands += 1
            raise ValidationError(
                f"takeoff altitude {altitude} > ceiling {self.max_altitude}"
            )
        return await self.inner.takeoff(altitude)

    async def land(self) -> bool:
        return await self.inner.land()

    async def emergency_stop(self) -> None:
        # never blocked by validation
        await self.inner.emergency_stop()

    def get_status(self) -> Dict[str, Any]:
        return {
            **self.inner.get_status(),
            "rejected_commands": self.rejected_commands,
        }
