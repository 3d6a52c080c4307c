"""Airframe parameter sets (PyTorch counterpart of
:mod:`dart_planner_tpu.config.airframe`).

A framework-free copy of the reference airframe configuration
(its config/airframe_config.py:23-260, "AF"): a typed per-airframe
parameter record with thrust/envelope helpers and validation (AF:82-145),
and a YAML-backed manager with named presets and override merging
(AF:146-260). Presets live in the port's own ``config/airframes.yaml``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import yaml

from dart_planner_tpu_torch.common.errors import ConfigurationError

_DEFAULT_YAML = Path(__file__).parent / "airframes.yaml"

_MOTOR_COUNT = {"quadcopter": 4, "hexacopter": 6, "octocopter": 8}


@dataclass(frozen=True)
class AirframeConfig:
    """One airframe's physical + envelope parameters (AF:23-70)."""

    name: str
    type: str = "quadcopter"
    mass: float = 1.0  # kg
    arm_length: float = 0.25  # m
    propeller_diameter: float = 0.24  # m
    max_thrust_per_motor: float = 7.5  # N
    max_velocity: float = 15.0  # m/s
    max_acceleration: float = 10.0  # m/s^2
    max_angular_velocity: float = 4.0  # rad/s
    max_altitude: float = 120.0  # m
    min_altitude: float = 0.5  # m
    max_distance: float = 1000.0  # m
    control_frequency: float = 400.0  # Hz
    gravity: float = 9.81

    @property
    def motor_count(self) -> int:
        return _MOTOR_COUNT.get(self.type, 4)

    def get_total_thrust(self) -> float:
        """(AF:82-93)"""
        return self.max_thrust_per_motor * self.motor_count

    def get_thrust_to_weight_ratio(self) -> float:
        """(AF:95-99)"""
        return self.get_total_thrust() / (self.mass * self.gravity)

    def validate_config(self) -> List[str]:
        """Physical-plausibility issues, empty when valid (AF:101-145)."""
        issues: List[str] = []
        if self.mass <= 0:
            issues.append("mass must be positive")
        if self.max_velocity <= 0:
            issues.append("max_velocity must be positive")
        if self.max_acceleration <= 0:
            issues.append("max_acceleration must be positive")
        if self.arm_length <= 0:
            issues.append("arm_length must be positive")
        if self.propeller_diameter <= 0:
            issues.append("propeller_diameter must be positive")
        if self.type not in _MOTOR_COUNT:
            issues.append(f"unknown airframe type {self.type!r}")
        ttw = self.get_thrust_to_weight_ratio()
        if ttw < 1.2:
            issues.append(f"thrust-to-weight too low: {ttw:.2f} (need >= 1.2)")
        elif ttw > 10.0:
            issues.append(f"thrust-to-weight too high: {ttw:.2f} (max 10.0)")
        if self.propeller_diameter >= 2 * self.arm_length:
            issues.append("propellers overlap (diameter >= 2 * arm_length)")
        return issues


class AirframeConfigManager:
    """YAML-backed registry of airframe presets (AF:146-260)."""

    def __init__(self, config_path: Optional[Union[str, Path]] = None):
        self.path = Path(config_path) if config_path else _DEFAULT_YAML
        self._configs: Dict[str, AirframeConfig] = {}
        self._default = "sitl_quad"
        self._load()

    def _load(self) -> None:
        if not self.path.exists():
            raise ConfigurationError(f"airframe file missing: {self.path}")
        data = yaml.safe_load(self.path.read_text()) or {}
        self._default = data.get("default", self._default)
        for name, params in (data.get("airframes") or {}).items():
            self._configs[name] = AirframeConfig(name=name, **params)
        if self._default not in self._configs:
            raise ConfigurationError(
                f"default airframe {self._default!r} not defined"
            )

    def get(self, name: Optional[str] = None) -> AirframeConfig:
        name = name or self._default
        if name not in self._configs:
            raise ConfigurationError(
                f"unknown airframe {name!r}; available: {self.list_airframes()}"
            )
        return self._configs[name]

    def list_airframes(self) -> List[str]:
        return sorted(self._configs)

    def add_custom(
        self, base: str, name: str, **overrides: Any
    ) -> AirframeConfig:
        """Derive a new airframe from a preset with overrides (AF:207-240)."""
        cfg = replace(self.get(base), name=name, **overrides)
        self._configs[name] = cfg
        return cfg


_manager: Optional[AirframeConfigManager] = None


def get_airframe_config(name: Optional[str] = None) -> AirframeConfig:
    """Module-level accessor over a shared manager."""
    global _manager
    if _manager is None:
        _manager = AirframeConfigManager()
    return _manager.get(name)
