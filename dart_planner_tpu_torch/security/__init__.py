"""Security layer (PyTorch counterpart of :mod:`dart_planner_tpu.security`):
input validation only, which the mission runner needs. Authentication,
rate limiting, keys, credentials and the user database are not ported yet."""

from dart_planner_tpu_torch.security.validation import (
    SafetyLimits,
    validate_attitude,
    validate_command_envelope,
    validate_control_command,
    validate_identifier,
    validate_position,
    validate_sensor_data,
    validate_trajectory,
    validate_waypoints,
)

__all__ = [
    "SafetyLimits",
    "validate_attitude",
    "validate_command_envelope",
    "validate_control_command",
    "validate_identifier",
    "validate_position",
    "validate_sensor_data",
    "validate_trajectory",
    "validate_waypoints",
]
