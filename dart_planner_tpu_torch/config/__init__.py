"""Frozen configuration system (PyTorch counterpart of
:mod:`dart_planner_tpu.config`, with the same exports).

Frozen pydantic models loaded from the port's own ``defaults.yaml`` plus
``DART_*`` environment overrides with startup validation, physical vehicle
parameters from ``hardware.yaml`` and airframe presets from
``airframes.yaml``: byte copies of the JAX package's three files.
"""

from dart_planner_tpu_torch.config.frozen_config import (
    CommunicationConfig,
    CoordinateFrameConfig,
    DARTPlannerFrozenConfig,
    HardwareConfig,
    LoggingConfig,
    PlanningConfig,
    SafetyConfig,
    SecurityConfig,
    SimulationConfig,
    ConfigurationManager,
    get_frozen_config,
    reset_frozen_config,
)
from dart_planner_tpu_torch.config.vehicle_params import (
    VehicleParams,
    load_vehicle_params,
    compute_max_torque_xyz,
)

__all__ = [
    "CommunicationConfig",
    "CoordinateFrameConfig",
    "DARTPlannerFrozenConfig",
    "HardwareConfig",
    "LoggingConfig",
    "PlanningConfig",
    "SafetyConfig",
    "SecurityConfig",
    "SimulationConfig",
    "ConfigurationManager",
    "get_frozen_config",
    "reset_frozen_config",
    "VehicleParams",
    "load_vehicle_params",
    "compute_max_torque_xyz",
]

from dart_planner_tpu_torch.config.airframe import (  # noqa: E402
    AirframeConfig,
    AirframeConfigManager,
    get_airframe_config,
)

__all__ += ["AirframeConfig", "AirframeConfigManager", "get_airframe_config"]
