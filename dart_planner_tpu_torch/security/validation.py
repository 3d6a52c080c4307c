"""Input validation: identifiers, positions, trajectories, commands,

A framework-free copy of :mod:`dart_planner_tpu.security.validation`: the port keeps its own,
since the JAX package cannot be imported without jax.
sensor data, with configurable safety limits.

Parity analog of the reference's ``InputValidator``
(the reference's security/validation.py:86-489, "V"):
everything that crosses a trust boundary — ZMQ trajectory payloads,
gateway commands, sensor feeds — is checked against a ``SafetyLimits``
envelope before the control stack touches it.

Differences from the reference, by design:

- trajectory validation is *array-first*: this stack's trajectories are
  fixed-shape arrays (timestamps/positions/velocities/accelerations),
  so the validator vectorizes over the horizon with numpy instead of
  the reference's per-waypoint dict loop (V:288-322). The dict-waypoint
  form is still accepted at the boundary (``validate_waypoints``).
- continuity is checked two ways: segment length (the reference's only
  check, V:462-489) AND position/velocity consistency (‖Δp − v·Δt‖
  bounded), which catches a spliced trajectory whose velocities do not
  match its positions — physically infeasible for the smoother even
  when every segment is short.
- control-command validation covers both the dict-typed boundary form
  (V:324-374) and the actuator-level thrust/torque envelope the
  reference never checks.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional

import numpy as np

from dart_planner_tpu_torch.common.device import to_host
from dart_planner_tpu_torch.common.errors import ValidationError

_IDENT_RE = re.compile(r"^[A-Za-z0-9_.-]{1,64}$")


@dataclass(frozen=True)
class SafetyLimits:
    """Operational envelope (V:56-84; same defaults)."""

    # spatial (m)
    max_altitude: float = 120.0  # AGL limit
    min_altitude: float = 0.0  # trajectory z floor (0 allows ground start)
    max_range: float = 1000.0  # distance from home
    # velocity (m/s)
    max_horizontal_velocity: float = 15.0
    max_vertical_velocity: float = 10.0
    max_angular_velocity: float = math.pi  # rad/s
    # acceleration (m/s^2)
    max_horizontal_acceleration: float = 5.0
    max_vertical_acceleration: float = 3.0
    # attitude (rad)
    max_roll: float = math.radians(45)
    max_pitch: float = math.radians(45)
    max_yaw_rate: float = math.radians(90)
    # mission
    max_waypoints: int = 1000
    max_mission_duration: float = 3600.0  # s
    max_segment_length: float = 100.0  # m (V:481)
    # actuator envelope (for validate_command_envelope)
    max_thrust: float = 100.0  # N
    max_torque: float = 10.0  # N*m
    # continuity: |dp - v*dt| per segment, fraction of max_segment_length
    continuity_tolerance: float = 0.5  # m per segment


DEFAULT_LIMITS = SafetyLimits()


def validate_identifier(value: str, name: str = "identifier") -> str:
    """Safe machine identifiers: alnum/underscore/dot/dash, <= 64 chars."""
    if not isinstance(value, str) or not _IDENT_RE.match(value):
        raise ValidationError(f"invalid {name}: {value!r}")
    return value


def validate_position(
    value,
    name: str = "position",
    max_abs: float = 10_000.0,
) -> np.ndarray:
    """Finite 3-vector within a sane envelope."""
    arr = to_host(value)
    if arr.shape != (3,):
        raise ValidationError(f"{name} must be a 3-vector, got shape {arr.shape}")
    if not np.isfinite(arr).all():
        raise ValidationError(f"{name} contains non-finite values")
    if np.any(np.abs(arr) > max_abs):
        raise ValidationError(f"{name} outside +-{max_abs} m envelope")
    return arr


def validate_waypoints(
    waypoints: Iterable, max_count: int = 1000
) -> list[np.ndarray]:
    """A bounded list of valid positions."""
    out = []
    for i, wp in enumerate(waypoints):
        if i >= max_count:
            raise ValidationError(f"more than {max_count} waypoints")
        pos = wp.get("position") if isinstance(wp, dict) else wp
        out.append(validate_position(pos, name=f"waypoint[{i}]"))
    if not out:
        raise ValidationError("empty waypoint list")
    return out


def _finite_array(value, shape_tail, name: str) -> np.ndarray:
    arr = to_host(value)
    if arr.ndim != 1 + len(shape_tail) or arr.shape[1:] != shape_tail:
        raise ValidationError(
            f"{name} must have shape (N,{','.join(map(str, shape_tail))})"
            f" — got {arr.shape}"
        )
    if not np.isfinite(arr).all():
        raise ValidationError(f"{name} contains non-finite values")
    return arr


def validate_trajectory(
    timestamps,
    positions,
    velocities=None,
    accelerations=None,
    limits: SafetyLimits = DEFAULT_LIMITS,
    home: Optional[np.ndarray] = None,
) -> None:
    """Full trajectory safety check (V:288-322 + V:462-489), vectorized.

    Raises ``ValidationError`` on: shape/finiteness violations, waypoint
    count, non-monotone or over-long timelines, altitude outside
    [min_altitude, max_altitude], range from ``home`` beyond max_range,
    per-axis velocity/acceleration limits, over-long segments, and
    position/velocity inconsistency (‖Δp − v̄·Δt‖ beyond tolerance —
    the C¹-continuity the dict-based reference check cannot see).
    """
    ts = to_host(timestamps)
    if ts.ndim != 1 or ts.size == 0:
        raise ValidationError("timestamps must be a non-empty 1-D array")
    if not np.isfinite(ts).all():
        raise ValidationError("timestamps contain non-finite values")
    n = ts.size
    if n > limits.max_waypoints:
        raise ValidationError(
            f"trajectory exceeds maximum waypoints: {n} > {limits.max_waypoints}"
        )
    if n > 1:
        dt = np.diff(ts)
        if np.any(dt <= 0):
            raise ValidationError("timestamps must be strictly increasing")
        if ts[-1] - ts[0] > limits.max_mission_duration:
            raise ValidationError(
                f"trajectory duration {ts[-1] - ts[0]:.1f} s exceeds "
                f"{limits.max_mission_duration} s"
            )

    pos = _finite_array(positions, (3,), "positions")
    if pos.shape[0] != n:
        raise ValidationError("positions length does not match timestamps")
    z = pos[:, 2]
    if np.any(z > limits.max_altitude) or np.any(z < limits.min_altitude):
        raise ValidationError(
            f"altitude outside [{limits.min_altitude}, "
            f"{limits.max_altitude}] m envelope"
        )
    if home is not None:
        rng = np.linalg.norm(pos - to_host(home), axis=-1)
        if np.any(rng > limits.max_range):
            raise ValidationError(
                f"trajectory leaves the {limits.max_range} m home range"
            )
    if n > 1:
        seg = np.linalg.norm(np.diff(pos, axis=0), axis=-1)
        if np.any(seg > limits.max_segment_length):
            i = int(np.argmax(seg))
            raise ValidationError(
                f"waypoint segment {i} too long: {seg[i]:.1f} m > "
                f"{limits.max_segment_length} m"
            )

    vel = None
    if velocities is not None:
        vel = _finite_array(velocities, (3,), "velocities")
        if vel.shape[0] != n:
            raise ValidationError("velocities length does not match timestamps")
        h = np.linalg.norm(vel[:, :2], axis=-1)
        if np.any(h > limits.max_horizontal_velocity):
            raise ValidationError(
                f"horizontal velocity exceeds "
                f"{limits.max_horizontal_velocity} m/s"
            )
        if np.any(np.abs(vel[:, 2]) > limits.max_vertical_velocity):
            raise ValidationError(
                f"vertical velocity exceeds {limits.max_vertical_velocity} m/s"
            )
        if n > 1:
            # C1 continuity: trapezoidal mean velocity must explain the
            # position increments
            dt = np.diff(ts)[:, None]
            dp = np.diff(pos, axis=0)
            vbar = 0.5 * (vel[1:] + vel[:-1])
            err = np.linalg.norm(dp - vbar * dt, axis=-1)
            if np.any(err > limits.continuity_tolerance):
                i = int(np.argmax(err))
                raise ValidationError(
                    f"position/velocity discontinuity at segment {i}: "
                    f"{err[i]:.2f} m > {limits.continuity_tolerance} m"
                )

    if accelerations is not None:
        acc = _finite_array(accelerations, (3,), "accelerations")
        if acc.shape[0] != n:
            raise ValidationError(
                "accelerations length does not match timestamps"
            )
        h = np.linalg.norm(acc[:, :2], axis=-1)
        if np.any(h > limits.max_horizontal_acceleration):
            raise ValidationError(
                f"horizontal acceleration exceeds "
                f"{limits.max_horizontal_acceleration} m/s^2"
            )
        if np.any(np.abs(acc[:, 2]) > limits.max_vertical_acceleration):
            raise ValidationError(
                f"vertical acceleration exceeds "
                f"{limits.max_vertical_acceleration} m/s^2"
            )


def _normalize_angle(a: float) -> float:
    return math.atan2(math.sin(a), math.cos(a))


def validate_attitude(
    attitude: Dict[str, float], limits: SafetyLimits = DEFAULT_LIMITS
) -> Dict[str, float]:
    """Roll/pitch/yaw dict: finite, normalized, within tilt limits
    (V:376-417)."""
    if not isinstance(attitude, dict):
        raise ValidationError("attitude must be a dict")
    out = {}
    for field in ("roll", "pitch", "yaw"):
        if field not in attitude:
            raise ValidationError(f"attitude missing {field}")
        v = attitude[field]
        if not isinstance(v, (int, float)) or not math.isfinite(v):
            raise ValidationError(f"attitude {field} must be finite")
        v = _normalize_angle(float(v))
        if field == "roll" and abs(v) > limits.max_roll:
            raise ValidationError(
                f"roll exceeds ±{math.degrees(limits.max_roll):.0f}°"
            )
        if field == "pitch" and abs(v) > limits.max_pitch:
            raise ValidationError(
                f"pitch exceeds ±{math.degrees(limits.max_pitch):.0f}°"
            )
        out[field] = v
    return out


VALID_COMMAND_TYPES = (
    "position", "velocity", "attitude", "emergency_stop", "takeoff", "land",
)


def validate_control_command(
    command: Dict[str, Any], limits: SafetyLimits = DEFAULT_LIMITS
) -> Dict[str, Any]:
    """Boundary-form command dict (V:324-374): type-tagged with a
    validated target, optional timestamp and 0-10 priority."""
    if not isinstance(command, dict):
        raise ValidationError("control command must be a dict")
    if "type" not in command:
        raise ValidationError("control command missing type")
    cmd_type = command["type"]
    if cmd_type not in VALID_COMMAND_TYPES:
        raise ValidationError(f"invalid command type: {cmd_type!r}")
    out: Dict[str, Any] = {"type": cmd_type}
    if cmd_type in ("position", "velocity"):
        if "target" not in command:
            raise ValidationError(f"{cmd_type} command missing target")
        target = validate_position(command["target"], name=cmd_type)
        if cmd_type == "velocity":
            h = float(np.linalg.norm(target[:2]))
            if h > limits.max_horizontal_velocity or (
                abs(target[2]) > limits.max_vertical_velocity
            ):
                raise ValidationError("velocity target exceeds safety limits")
        out["target"] = target
    elif cmd_type == "attitude":
        if "target" not in command:
            raise ValidationError("attitude command missing target")
        out["target"] = validate_attitude(command["target"], limits)
    if "timestamp" in command:
        t = command["timestamp"]
        if not isinstance(t, (int, float)) or not math.isfinite(t) or t < 0:
            raise ValidationError("invalid timestamp")
        out["timestamp"] = float(t)
    if "priority" in command:
        p = command["priority"]
        if not isinstance(p, int) or p < 0 or p > 10:
            raise ValidationError("priority must be an integer 0-10")
        out["priority"] = p
    return out


def validate_command_envelope(
    thrust: float,
    torque,
    limits: SafetyLimits = DEFAULT_LIMITS,
) -> None:
    """Actuator-level envelope for a thrust/torque ControlCommand — the
    form this stack actually actuates (common/types.py ControlCommand);
    the reference validates only the dict boundary form."""
    if not math.isfinite(float(thrust)) or float(thrust) < 0.0:
        raise ValidationError("thrust must be finite and non-negative")
    if float(thrust) > limits.max_thrust:
        raise ValidationError(
            f"thrust {float(thrust):.1f} N exceeds {limits.max_thrust} N"
        )
    tq = to_host(torque)
    if tq.shape != (3,) or not np.isfinite(tq).all():
        raise ValidationError("torque must be a finite 3-vector")
    if np.any(np.abs(tq) > limits.max_torque):
        raise ValidationError(
            f"torque exceeds ±{limits.max_torque} N·m envelope"
        )


def validate_sensor_data(
    sensor_data: Dict[str, Any],
    sensor_type: str,
    limits: SafetyLimits = DEFAULT_LIMITS,
) -> Dict[str, Any]:
    """IMU / GPS payload validation (V:419-460)."""
    if not isinstance(sensor_data, dict):
        raise ValidationError("sensor data must be a dict")
    out: Dict[str, Any] = {}
    if sensor_type == "imu":
        for field in ("accelerometer", "gyroscope"):
            if field not in sensor_data:
                raise ValidationError(f"IMU data missing {field}")
            out[field] = validate_position(sensor_data[field], name=field)
        if np.any(
            np.abs(out["gyroscope"]) > limits.max_angular_velocity * 10
        ):
            # 10x envelope: raw gyro can exceed commanded rates, but
            # beyond that it is sensor garbage, not motion
            raise ValidationError("gyroscope reading implausibly large")
        if "magnetometer" in sensor_data:
            out["magnetometer"] = validate_position(
                sensor_data["magnetometer"], name="magnetometer"
            )
    elif sensor_type == "gps":
        for field in ("latitude", "longitude", "altitude"):
            if field not in sensor_data:
                raise ValidationError(f"GPS data missing {field}")
            v = sensor_data[field]
            if not isinstance(v, (int, float)) or not math.isfinite(v):
                raise ValidationError(f"invalid GPS {field}")
            if field == "latitude" and not -90 <= v <= 90:
                raise ValidationError("latitude out of range [-90, 90]")
            if field == "longitude" and not -180 <= v <= 180:
                raise ValidationError("longitude out of range [-180, 180]")
            out[field] = float(v)
    else:
        raise ValidationError(f"unknown sensor type: {sensor_type!r}")
    if "timestamp" in sensor_data:
        t = sensor_data["timestamp"]
        if not isinstance(t, (int, float)) or not math.isfinite(t) or t < 0:
            raise ValidationError("invalid timestamp")
        out["timestamp"] = float(t)
    return out
