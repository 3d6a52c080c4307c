"""Hardware abstraction layer (PyTorch counterpart of
:mod:`dart_planner_tpu.hardware`): a ``VehicleIO`` ABC + factory, the
pure-software simulated vehicle, physics-based motor mixing and models, the
mission runner, the state-level safety manager, the heartbeat safety
watchdog, the transport-delay buffer, the motor latency calibration, the
auth-gated secure command channel, the motor-mixing schema, and the AirSim
and MAVLink adapters. The adapters' clients are import-gated (``airsim``,
``pymavlink``) and injectable; their states live on the card unless a
``device`` is given."""

from dart_planner_tpu_torch.hardware.vehicle_io import (
    VehicleIO,
    VehicleIOFactory,
    SafetyValidatedVehicleIO,
)
from dart_planner_tpu_torch.hardware.simulated_vehicle import SimulatedVehicleIO
from dart_planner_tpu_torch.hardware.motor_model import (
    MotorParameters,
    QuadraticMotorModel,
    create_default_motor_model,
    fit_quadratic_motor_model,
)
from dart_planner_tpu_torch.hardware.motor_mixer import (
    MotorMixer,
    MotorMixingConfig,
    create_x_configuration,
    create_plus_configuration,
)
from dart_planner_tpu_torch.hardware.safety_watchdog import SafetyWatchdog
from dart_planner_tpu_torch.hardware.latency_buffer import LatencyBuffer
from dart_planner_tpu_torch.hardware.safety import SafetyLimits, SafetyManager
from dart_planner_tpu_torch.hardware.mission import (
    MissionConfig,
    MissionRunner,
    start_mission,
)

__all__ = [
    "MissionConfig",
    "MissionRunner",
    "start_mission",
    "VehicleIO",
    "VehicleIOFactory",
    "SafetyValidatedVehicleIO",
    "SimulatedVehicleIO",
    "MotorParameters",
    "QuadraticMotorModel",
    "create_default_motor_model",
    "fit_quadratic_motor_model",
    "MotorMixer",
    "MotorMixingConfig",
    "create_x_configuration",
    "create_plus_configuration",
    "SafetyWatchdog",
    "LatencyBuffer",
    "SafetyLimits",
    "SafetyManager",
]
from dart_planner_tpu_torch.hardware.motor_calibration import (  # noqa: E402
    CalibrationResult,
    MotorLatencyCalibrator,
    calibrate_motor_latency,
)
from dart_planner_tpu_torch.hardware.secure_interface import (  # noqa: E402
    ConnectionState,
    SecureHardwareInterface,
    create_secure_interface,
)
from dart_planner_tpu_torch.hardware.airsim_interface import (  # noqa: E402
    AirSimConfig,
    AirSimDroneInterface,
    AirSimVehicleIO,
)
from dart_planner_tpu_torch.hardware.mixing_schema import (  # noqa: E402
    MotorMixingModel,
    validate_motor_mixing,
)

__all__ += [
    "CalibrationResult",
    "MotorLatencyCalibrator",
    "calibrate_motor_latency",
    "ConnectionState",
    "SecureHardwareInterface",
    "create_secure_interface",
    "AirSimConfig",
    "AirSimDroneInterface",
    "AirSimVehicleIO",
    "MotorMixingModel",
    "validate_motor_mixing",
]
