"""Physical vehicle parameters from hardware.yaml (PyTorch counterpart of
:mod:`dart_planner_tpu.config.vehicle_params`).

A framework-free copy, read from the port's own copy of ``hardware.yaml``:
it loads arm geometry / motor limits, derives the max torque envelope from
geometry (the reference's vehicle_params.py:100), and exposes a
pre-stripped constants dict for hot loops (:68). Host values: numpy, as in
the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import yaml

from dart_planner_tpu_torch.common.errors import ConfigurationError

_DEFAULT_PATH = Path(__file__).parent / "hardware.yaml"


@dataclass(frozen=True)
class TransportDelayConfig:
    """(reference config/hardware.yaml transport_delay:)"""

    delay_ms: float = 25.0
    control_loop_period_ms: float = 5.0
    enabled: bool = True
    max_buffer_size: int = 1000


@dataclass(frozen=True)
class VehicleParams:
    """(reference vehicle_params.py dataclass)"""

    mass: float = 1.5  # kg
    arm_length: float = 0.225  # m
    max_motor_thrust: float = 12.0  # N per motor
    max_propeller_drag_torque: float = 0.18  # N m per prop
    num_arms: int = 4
    geometry: str = "x"
    inertia: tuple = (0.02, 0.02, 0.04)  # kg m^2 diag
    gravity: float = 9.81
    transport_delay: TransportDelayConfig = field(
        default_factory=TransportDelayConfig
    )

    @property
    def max_total_thrust(self) -> float:
        return self.num_arms * self.max_motor_thrust

    @property
    def hover_throttle_fraction(self) -> float:
        return (self.mass * self.gravity) / self.max_total_thrust


def compute_max_torque_xyz(params: VehicleParams) -> np.ndarray:
    """Torque envelope from geometry (reference vehicle_params.py:100):
    roll/pitch = arm_length_effective * max differential thrust,
    yaw = sum of propeller drag torques (half spin each way)."""
    eff = params.arm_length * (
        np.sin(np.pi / 4) if params.geometry == "x" else 1.0
    )
    # two motors up, two down -> differential thrust = 2 * max_motor_thrust
    tau_xy = eff * 2.0 * params.max_motor_thrust
    tau_z = (params.num_arms / 2.0) * params.max_propeller_drag_torque * 2.0
    return np.array([tau_xy, tau_xy, tau_z])


def get_control_constants(params: VehicleParams) -> Dict[str, Any]:
    """Pre-stripped dict for hot loops (reference vehicle_params.py:68)."""
    tau = compute_max_torque_xyz(params)
    return {
        "mass": params.mass,
        "gravity": params.gravity,
        "inertia": np.asarray(params.inertia),
        "max_thrust": params.max_total_thrust,
        "max_torque_xyz": tau,
        "hover_thrust": params.mass * params.gravity,
    }


def load_vehicle_params(path: Optional[str | Path] = None) -> VehicleParams:
    """Load hardware.yaml (reference vehicle_params.py:49-123)."""
    p = Path(path) if path else _DEFAULT_PATH
    if not p.exists():
        return VehicleParams()
    try:
        with open(p) as f:
            raw = yaml.safe_load(f) or {}
    except (OSError, yaml.YAMLError) as e:
        raise ConfigurationError(f"failed to load {p}: {e}") from e
    td_raw = raw.get("transport_delay", {})
    td = TransportDelayConfig(
        delay_ms=float(td_raw.get("delay_ms", 25.0)),
        control_loop_period_ms=float(td_raw.get("control_loop_period_ms", 5.0)),
        enabled=bool(td_raw.get("enabled", True)),
        max_buffer_size=int(td_raw.get("max_buffer_size", 1000)),
    )
    return VehicleParams(
        mass=float(raw.get("mass", 1.5)),
        arm_length=float(raw.get("arm_length", 0.225)),
        max_motor_thrust=float(raw.get("max_motor_thrust", 12.0)),
        max_propeller_drag_torque=float(
            raw.get("max_propeller_drag_torque", 0.18)
        ),
        num_arms=int(raw.get("num_arms", 4)),
        geometry=str(raw.get("geometry", "x")),
        inertia=tuple(raw.get("inertia", (0.02, 0.02, 0.04))),
        transport_delay=td,
    )
