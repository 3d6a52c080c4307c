"""Frozen pydantic configuration with YAML + env overrides (PyTorch
counterpart of :mod:`dart_planner_tpu.config.frozen_config`).

A framework-free copy: the same section models, ``DART_*`` environment
overrides, startup validation and freeze-after-boot semantics as the JAX
package's ("FC" below: the reference's config/frozen_config.py), read
from the port's own copy of ``defaults.yaml``. The sections map onto the
port's solver and runtime: ``PlanningConfig.to_se3_config()`` builds a
:class:`dart_planner_tpu_torch.planning.se3_mpc.SE3MPCConfig` and
``RealTimeConfig.quartic_tasks`` the port's scheduler tasks. The
``get_frozen_config`` singleton is the port's own.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Optional

import yaml
from pydantic import BaseModel, Field, field_validator, model_validator

from dart_planner_tpu_torch.common.errors import ConfigurationError

_DEFAULTS_PATH = Path(__file__).parent / "defaults.yaml"


class SecurityConfig(BaseModel, frozen=True):
    """(FC SecurityConfig; defaults.yaml security:)"""

    enable_authentication: bool = True
    enable_ssl: bool = False
    secret_key: str = ""
    token_expiry_hours: int = 24


class HardwareConfig(BaseModel, frozen=True):
    """(FC HardwareConfig; defaults.yaml hardware:)"""

    control_frequency: float = Field(400.0, gt=0, le=2000)
    planning_frequency: float = Field(50.0, gt=0, le=1000)
    telemetry_frequency: float = Field(10.0, gt=0)
    mavlink_connection: str = "/dev/ttyUSB0"
    baud_rate: int = 921600

    @field_validator("planning_frequency")
    @classmethod
    def _planning_below_control(cls, v, info):
        cf = info.data.get("control_frequency", 400.0)
        if v > cf:
            raise ValueError(
                f"planning_frequency {v} must not exceed control_frequency {cf}"
            )
        return v


class RealTimeConfig(BaseModel, frozen=True):
    """(FC RealTimeConfig, frozen_config.py:82-112): loop frequencies,
    per-loop latency budgets, deadline/jitter monitoring, and scheduler
    priorities. Cross-validated at construction: every loop's latency
    budget must fit inside its own period — the startup check the
    reference runs in its RT-requirement validation (FC:531-589)."""

    control_loop_frequency_hz: float = Field(400.0, ge=50.0, le=1000.0)
    planning_loop_frequency_hz: float = Field(25.0, ge=1.0, le=100.0)
    safety_loop_frequency_hz: float = Field(100.0, ge=10.0, le=500.0)
    max_control_latency_ms: float = Field(2.5, ge=0.1, le=10.0)
    max_planning_latency_ms: float = Field(40.0, ge=1.0, le=100.0)
    max_safety_latency_ms: float = Field(10.0, ge=0.1, le=50.0)
    enable_deadline_monitoring: bool = True
    enable_jitter_compensation: bool = True
    max_jitter_ms: float = Field(0.1, ge=0.01, le=1.0)
    enable_priority_scheduling: bool = True
    control_priority: int = Field(90, ge=1, le=99)
    planning_priority: int = Field(70, ge=1, le=99)
    safety_priority: int = Field(95, ge=1, le=99)

    @model_validator(mode="after")
    def _budgets_fit_periods(self):
        for loop in ("control", "planning", "safety"):
            period_ms = 1e3 / getattr(self, f"{loop}_loop_frequency_hz")
            budget = getattr(self, f"max_{loop}_latency_ms")
            if budget > period_ms:
                raise ValueError(
                    f"max_{loop}_latency_ms {budget} exceeds the "
                    f"{loop}-loop period {period_ms:.2f} ms"
                )
        return self

    def quartic_tasks(self, control_fn, planning_fn, safety_fn):
        """The three standard loops as runtime.scheduler QuarticTasks
        (reference quartic_scheduler.py:579-612 creates control/
        planning/safety tasks at analogous rates/priorities); each
        task's deadline fraction encodes this config's latency budget
        within its loop period."""
        from dart_planner_tpu_torch.runtime.scheduler import (
            QuarticTask,
            TaskPriority,
        )

        def frac(budget_ms: float, freq_hz: float) -> float:
            return min(budget_ms * freq_hz / 1e3, 1.0)

        return [
            QuarticTask(
                name="safety", func=safety_fn,
                frequency_hz=self.safety_loop_frequency_hz,
                priority=TaskPriority.CRITICAL,
                deadline_fraction=frac(
                    self.max_safety_latency_ms,
                    self.safety_loop_frequency_hz,
                ),
            ),
            QuarticTask(
                name="control", func=control_fn,
                frequency_hz=self.control_loop_frequency_hz,
                priority=TaskPriority.HIGH,
                deadline_fraction=frac(
                    self.max_control_latency_ms,
                    self.control_loop_frequency_hz,
                ),
            ),
            QuarticTask(
                name="planning", func=planning_fn,
                frequency_hz=self.planning_loop_frequency_hz,
                priority=TaskPriority.MEDIUM,
                deadline_fraction=frac(
                    self.max_planning_latency_ms,
                    self.planning_loop_frequency_hz,
                ),
            ),
        ]


class CommunicationConfig(BaseModel, frozen=True):
    """(FC CommunicationConfig; defaults.yaml communication:)"""

    zmq_host: str = "localhost"
    zmq_port: int = Field(5555, gt=0, lt=65536)
    zmq_bind_address: str = "127.0.0.1"
    enable_heartbeat: bool = True
    heartbeat_interval_ms: int = 100
    heartbeat_timeout_ms: int = 500


class PlanningConfig(BaseModel, frozen=True):
    """(defaults.yaml planning: — reference horizon 8 / dt 0.1; the TPU
    north star raises the default horizon to 20)."""

    prediction_horizon: int = Field(20, ge=2, le=100)
    dt: float = Field(0.1, gt=0, le=1.0)
    max_iterations: int = Field(12, gt=0)
    convergence_tolerance: float = 0.05
    position_weight: float = 100.0
    velocity_weight: float = 10.0
    obstacle_weight: float = 1000.0
    safety_margin: float = 1.5

    def to_se3_config(self):
        from dart_planner_tpu_torch.planning.se3_mpc import SE3MPCConfig

        return SE3MPCConfig(
            prediction_horizon=self.prediction_horizon,
            dt=self.dt,
            max_iterations=self.max_iterations,
            convergence_tolerance=self.convergence_tolerance,
            position_weight=self.position_weight,
            velocity_weight=self.velocity_weight,
            obstacle_weight=self.obstacle_weight,
            safety_margin=self.safety_margin,
        )


class SafetyConfig(BaseModel, frozen=True):
    """(defaults.yaml safety:)"""

    max_velocity: float = 15.0
    max_acceleration: float = 10.0
    max_altitude: float = 50.0
    safety_radius: float = 100.0
    emergency_landing_altitude: float = 2.0


class LoggingConfig(BaseModel, frozen=True):
    level: str = "INFO"
    enable_console: bool = True
    enable_file: bool = False
    file: Optional[str] = None


class SimulationConfig(BaseModel, frozen=True):
    use_airsim: bool = True
    airsim_host: str = "localhost"
    airsim_port: int = 41451
    simulation_speed: float = 1.0


class CoordinateFrameConfig(BaseModel, frozen=True):
    """(FC CoordinateFrameConfig; defaults.yaml coordinate_frame:)"""

    world_frame: str = "ENU"
    enforce_consistency: bool = True

    @field_validator("world_frame")
    @classmethod
    def _frame_valid(cls, v):
        if v not in ("ENU", "NED"):
            raise ValueError(f"world_frame must be ENU or NED, got {v}")
        return v


class DARTPlannerFrozenConfig(BaseModel, frozen=True):
    """Root config (FC:319-372)."""

    environment: str = "development"
    debug: bool = False
    security: SecurityConfig = SecurityConfig()
    hardware: HardwareConfig = HardwareConfig()
    real_time: RealTimeConfig = RealTimeConfig()
    communication: CommunicationConfig = CommunicationConfig()
    planning: PlanningConfig = PlanningConfig()
    safety: SafetyConfig = SafetyConfig()
    logging: LoggingConfig = LoggingConfig()
    simulation: SimulationConfig = SimulationConfig()
    coordinate_frame: CoordinateFrameConfig = CoordinateFrameConfig()
    custom_settings: Dict[str, Any] = Field(default_factory=dict)


# env override map: DART_<NAME> -> (section, field, cast) (FC:441-489)
_ENV_OVERRIDES = {
    "DART_ENVIRONMENT": (None, "environment", str),
    "DART_DEBUG": (None, "debug", lambda v: v.lower() in ("1", "true", "yes")),
    "DART_ZMQ_HOST": ("communication", "zmq_host", str),
    "DART_ZMQ_PORT": ("communication", "zmq_port", int),
    "DART_CONTROL_FREQUENCY": ("hardware", "control_frequency", float),
    "DART_RT_CONTROL_FREQUENCY": (
        "real_time", "control_loop_frequency_hz", float),
    "DART_RT_PLANNING_FREQUENCY": (
        "real_time", "planning_loop_frequency_hz", float),
    "DART_RT_MAX_PLANNING_LATENCY_MS": (
        "real_time", "max_planning_latency_ms", float),
    "DART_PLANNING_FREQUENCY": ("hardware", "planning_frequency", float),
    "DART_PREDICTION_HORIZON": ("planning", "prediction_horizon", int),
    "DART_PLANNING_DT": ("planning", "dt", float),
    "DART_MAX_VELOCITY": ("safety", "max_velocity", float),
    "DART_LOG_LEVEL": ("logging", "level", str),
    "DART_WORLD_FRAME": ("coordinate_frame", "world_frame", str),
    "DART_SECRET_KEY": ("security", "secret_key", str),
}


class ConfigurationManager:
    """Loads YAML + env overrides, validates, freezes (FC:374-612)."""

    def __init__(self, config_path: Optional[str | Path] = None):
        self._config_path = Path(config_path) if config_path else None
        self._config: Optional[DARTPlannerFrozenConfig] = None

    def load(self) -> DARTPlannerFrozenConfig:
        data: Dict[str, Any] = {}
        path = self._config_path or (
            _DEFAULTS_PATH if _DEFAULTS_PATH.exists() else None
        )
        if path is not None:
            try:
                with open(path) as f:
                    data = yaml.safe_load(f) or {}
            except (OSError, yaml.YAMLError) as e:
                raise ConfigurationError(f"failed to load {path}: {e}") from e
        data = self._apply_env_overrides(data)
        try:
            self._config = DARTPlannerFrozenConfig(**data)
        except Exception as e:
            raise ConfigurationError(f"invalid configuration: {e}") from e
        return self._config

    @staticmethod
    def _apply_env_overrides(data: Dict[str, Any]) -> Dict[str, Any]:
        for env, (section, field_name, cast) in _ENV_OVERRIDES.items():
            raw = os.environ.get(env)
            if raw is None:
                continue
            try:
                value = cast(raw)
            except ValueError as e:
                raise ConfigurationError(f"bad env override {env}={raw}") from e
            if section is None:
                data[field_name] = value
            else:
                data.setdefault(section, {})
                if isinstance(data[section], dict):
                    data[section][field_name] = value
        return data

    @property
    def config(self) -> DARTPlannerFrozenConfig:
        if self._config is None:
            return self.load()
        return self._config


_manager: Optional[ConfigurationManager] = None


def get_frozen_config(
    config_path: Optional[str | Path] = None,
) -> DARTPlannerFrozenConfig:
    """Process-wide frozen config (FC:597). Frozen: pydantic rejects any
    mutation after construction."""
    global _manager
    if _manager is None or config_path is not None:
        _manager = ConfigurationManager(config_path)
    return _manager.config


def reset_frozen_config() -> None:
    """Testing hook: drop the cached config."""
    global _manager
    _manager = None
