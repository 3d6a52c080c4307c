"""Auth-gated hardware command channel (PyTorch counterpart
of :mod:`dart_planner_tpu.hardware.secure_interface`).

Parity port of the reference ``SecureHardwareInterface``
(the reference's hardware/secure_hardware_interface.py,
"SHI"): every hardware command passes a token check against a per-command
permission map (SHI:379-396), is appended to a bounded audit log
(SHI:340-456), and is blocked while the software emergency stop is engaged
(SHI:246-338). Emergency-stop disengage requires a fresh authentication.

Built over the framework's own pieces: tokens come from
:class:`~dart_planner_tpu_torch.security.auth.AuthManager`, the transport is any
:class:`~dart_planner_tpu_torch.hardware.vehicle_io.VehicleIO`.
"""

from __future__ import annotations

import enum
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from dart_planner_tpu_torch.common.errors import SecurityError, UnsupportedCommandError
from dart_planner_tpu_torch.security.auth import AuthManager

_AUDIT_CAP = 1000


class ConnectionState(enum.Enum):
    """(SHI:36-44)"""

    DISCONNECTED = "disconnected"
    CONNECTING = "connecting"
    CONNECTED = "connected"
    EMERGENCY_STOP = "emergency_stop"


@dataclass
class HardwareCommand:
    """Audit-log record (SHI:46-54)."""

    command_type: str
    parameters: Dict[str, Any]
    issued_by: str
    timestamp: float = field(default_factory=time.time)
    status: str = "pending"


# command -> required permission (SHI:379-396). Permission names match
# security.auth.ROLE_PERMISSIONS.
COMMAND_PERMISSIONS: Dict[str, str] = {
    "arm": "arm",
    "disarm": "arm",
    "takeoff": "takeoff",
    "land": "land",
    "set_mission": "set_mission",
    "send_trajectory": "set_mission",
    "emergency_stop": "view",  # anyone authenticated may stop
    "telemetry": "view",
}


class SecureHardwareInterface:
    """Permission-checked, audited wrapper over a VehicleIO (SHI:56-482)."""

    def __init__(self, vehicle_io, auth: AuthManager):
        self.vehicle = vehicle_io
        self.auth = auth
        self.state = ConnectionState.DISCONNECTED
        self._estop_engaged = False
        self._audit: deque = deque(maxlen=_AUDIT_CAP)

    # -- auth helpers --------------------------------------------------
    def _check(self, token: str, command_type: str) -> str:
        """Validate token + permission; returns the username. The token
        is RSA-verified once and the role read from its payload."""
        from dart_planner_tpu_torch.security.auth import ROLE_PERMISSIONS, Role

        perm = COMMAND_PERMISSIONS.get(command_type)
        if perm is None:
            raise UnsupportedCommandError(f"unknown command {command_type!r}")
        payload = self.auth.verify_token(token)
        perms = ROLE_PERMISSIONS.get(Role(payload.get("role", "viewer")), [])
        if "*" not in perms and perm not in perms:
            self._log(
                HardwareCommand(command_type, {}, payload.get("sub", "?")),
                "denied",
            )
            raise SecurityError(
                f"{payload.get('sub')} lacks permission {perm!r} "
                f"for {command_type!r}"
            )
        return payload.get("sub", "?")

    def _log(self, cmd: HardwareCommand, status: str) -> None:
        cmd.status = status
        self._audit.append(cmd)

    # -- lifecycle (SHI:90-132, 458-482) -------------------------------
    async def connect(self, token: str) -> bool:
        self._check(token, "telemetry")
        self.state = ConnectionState.CONNECTING
        ok = await self.vehicle.connect()
        self.state = (
            ConnectionState.CONNECTED if ok else ConnectionState.DISCONNECTED
        )
        return ok

    async def disconnect(self, token: str) -> bool:
        self._check(token, "telemetry")
        await self.vehicle.disconnect()
        self.state = ConnectionState.DISCONNECTED
        return True

    # -- commands (SHI:134-206) ----------------------------------------
    async def send_secure_command(
        self,
        token: str,
        command_type: str,
        parameters: Optional[Dict[str, Any]] = None,
    ) -> bool:
        """Auth + estop gate + dispatch + audit."""
        params = dict(parameters or {})
        user = self._check(token, command_type)
        cmd = HardwareCommand(command_type, params, user)
        if self._estop_engaged and command_type != "emergency_stop":
            self._log(cmd, "blocked_estop")
            raise SecurityError("emergency stop engaged; command blocked")
        try:
            ok = await self._dispatch(command_type, params)
        except Exception:
            self._log(cmd, "error")
            raise
        self._log(cmd, "executed" if ok else "failed")
        return ok

    async def _dispatch(self, command_type: str, params: Dict[str, Any]) -> bool:
        if command_type == "arm":
            return await self.vehicle.arm()
        if command_type == "disarm":
            return await self.vehicle.disarm()
        if command_type == "takeoff":
            return await self.vehicle.takeoff(params.get("altitude", 2.0))
        if command_type == "land":
            return await self.vehicle.land()
        if command_type in ("set_mission", "send_trajectory"):
            return await self.vehicle.send_trajectory(params["trajectory"])
        if command_type == "emergency_stop":
            # latch the software estop exactly as the dedicated method does
            self._estop_engaged = True
            self.state = ConnectionState.EMERGENCY_STOP
            await self.vehicle.emergency_stop()
            return True
        raise UnsupportedCommandError(command_type)

    # -- telemetry (SHI:208-244) ---------------------------------------
    def get_secure_telemetry(self, token: str) -> Dict[str, Any]:
        self._check(token, "telemetry")
        status = self.vehicle.get_status()
        return {
            **status,
            "connection_state": self.state.value,
            "emergency_stop_engaged": self._estop_engaged,
        }

    # -- emergency stop (SHI:246-338) ----------------------------------
    async def emergency_stop(self, token: str) -> bool:
        user = self._check(token, "emergency_stop")
        self._estop_engaged = True
        self.state = ConnectionState.EMERGENCY_STOP
        await self.vehicle.emergency_stop()
        self._log(HardwareCommand("emergency_stop", {}, user), "executed")
        return True

    def disengage_emergency_stop(
        self, token: str, username: str, password: str
    ) -> bool:
        """Requires re-authentication with operator rights (SHI:296-338)."""
        self._check(token, "arm")
        user = self.auth.authenticate(username, password)
        if user is None:
            self._log(
                HardwareCommand("disengage_estop", {}, username), "denied"
            )
            raise SecurityError("re-authentication failed")
        self._estop_engaged = False
        self.state = ConnectionState.CONNECTED
        self._log(HardwareCommand("disengage_estop", {}, username), "executed")
        return True

    # -- audit (SHI:340-377) -------------------------------------------
    def get_command_audit_log(
        self, token: str, limit: int = 100
    ) -> List[Dict[str, Any]]:
        self._check(token, "telemetry")
        entries = list(self._audit)[-limit:]
        return [
            {
                "command_type": c.command_type,
                "issued_by": c.issued_by,
                "timestamp": c.timestamp,
                "status": c.status,
            }
            for c in entries
        ]

    def get_connection_status(self) -> Dict[str, Any]:
        """(SHI:470-482)"""
        return {
            "state": self.state.value,
            "emergency_stop_engaged": self._estop_engaged,
            "audit_entries": len(self._audit),
        }


def create_secure_interface(vehicle_io, auth: AuthManager) -> SecureHardwareInterface:
    """(SHI:484)"""
    return SecureHardwareInterface(vehicle_io, auth)
