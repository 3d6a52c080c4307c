"""Exception taxonomy, a framework-free copy of
:mod:`dart_planner_tpu.common.errors` (identical domains, so callers port
error handling 1:1; the JAX package cannot be imported without jax)."""


class DARTPlannerError(Exception):
    """Base exception for all framework errors."""


class ConfigurationError(DARTPlannerError):
    """Configuration loading/validation errors."""


class DependencyError(DARTPlannerError):
    """Dependency injection / resolution errors."""


class CommunicationError(DARTPlannerError):
    """Network / IPC errors."""


class ControlError(DARTPlannerError):
    """Control-system errors."""


class PlanningError(DARTPlannerError):
    """Planning / solver errors."""


class HardwareError(DARTPlannerError):
    """Hardware interface errors."""


class ValidationError(DARTPlannerError):
    """Input or data validation errors."""


class SecurityError(DARTPlannerError):
    """Auth / crypto errors."""


class RealTimeError(DARTPlannerError):
    """Real-time system errors."""


class SchedulingError(DARTPlannerError):
    """Task scheduling errors."""


class TimingError(DARTPlannerError):
    """Timing / deadline violations."""


class UnsupportedCommandError(HardwareError):
    """Hardware command not supported by the adapter."""
