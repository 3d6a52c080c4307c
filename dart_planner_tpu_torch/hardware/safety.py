"""State-level safety monitoring (PyTorch counterpart of
:mod:`dart_planner_tpu.hardware.safety`).

Port of the reference ``hardware/safety.py`` (``AirSimSafetyManager``,
:20-188) generalized over any ``VehicleIO``: checks the *live state*
against geofence / altitude / velocity envelopes every tick and triggers
emergency landing on violation. This complements the trajectory gate in
:class:`~dart_planner_tpu_torch.hardware.vehicle_io.SafetyValidatedVehicleIO`,
which can only validate one short-horizon plan at a time (a slow climb
toward an unsafe goal passes every per-plan check; the state monitor is
what catches it).

The manager holds no tensors: it reduces a state on the state's own device
to four numbers — finite, altitude, horizontal radius, speed — and reads
them to the host once a check, through
:func:`~dart_planner_tpu_torch.common.device.to_host`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from dart_planner_tpu_torch.common.device import to_host
from dart_planner_tpu_torch.common.types import DroneState
from dart_planner_tpu_torch.hardware.vehicle_io import VehicleIO


@dataclass
class SafetyLimits:
    """(reference safety.py config fields; defaults.yaml safety:)"""

    max_altitude: float = 50.0
    safety_radius: float = 100.0
    max_velocity: float = 15.0
    emergency_landing_altitude: float = 2.0


class SafetyManager:
    """(reference safety.py:20-188)"""

    def __init__(self, limits: Optional[SafetyLimits] = None):
        self.limits = limits or SafetyLimits()
        self.violations = 0
        self.last_violation: Optional[str] = None
        self.emergency_active = False

    def check_state(self, state: DroneState) -> Optional[str]:
        """Returns a violation description or None."""
        pos = state.position.to(torch.float32)
        vel = state.velocity.to(pos.device, torch.float32)
        finite, z, radius, speed = to_host(torch.stack([
            torch.isfinite(pos).all().to(torch.float32),
            pos[2],
            torch.linalg.vector_norm(pos[:2]),
            torch.linalg.vector_norm(vel),
        ]), "float32").tolist()
        if not finite:
            return "non-finite position"
        if z > self.limits.max_altitude:
            return f"altitude {z:.1f} > ceiling {self.limits.max_altitude}"
        if radius > self.limits.safety_radius:
            return f"radius {radius:.1f} > geofence {self.limits.safety_radius}"
        if speed > self.limits.max_velocity:
            return f"speed {speed:.1f} > envelope {self.limits.max_velocity}"
        return None

    async def monitor_safety(self, state: DroneState, vehicle: VehicleIO) -> bool:
        """One safety tick (reference :38-71). Returns True if safe."""
        violation = self.check_state(state)
        if violation is None:
            return True
        self.violations += 1
        self.last_violation = violation
        if not self.emergency_active:
            self.emergency_active = True
            await self.emergency_land(vehicle)
        return False

    async def emergency_land(self, vehicle: VehicleIO) -> None:
        """(reference :73-122)"""
        try:
            await vehicle.land()
        except Exception:
            await vehicle.emergency_stop()

    def get_safety_violations(self) -> int:
        return self.violations

    def reset_safety_violations(self) -> None:
        self.violations = 0
        self.emergency_active = False
        self.last_violation = None
