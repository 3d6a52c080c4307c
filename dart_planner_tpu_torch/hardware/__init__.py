"""Hardware abstraction layer (PyTorch counterpart of
:mod:`dart_planner_tpu.hardware`): a ``VehicleIO`` ABC + factory, the
pure-software simulated vehicle, physics-based motor mixing and models, the
mission runner, the state-level safety manager, the heartbeat safety
watchdog and the transport-delay buffer. The MAVLink and AirSim adapters,
the secure interface, the mixing schema and the motor calibration are not
ported yet."""

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
