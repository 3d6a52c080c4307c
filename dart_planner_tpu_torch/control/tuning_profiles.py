"""Controller gain profiles (PyTorch counterpart of
:mod:`dart_planner_tpu.control.tuning_profiles`).

Named profiles for different flight regimes, a registry with custom-profile
support, scenario -> profile recommendations, and ``get_controller_config``
as the lookup entry point. A profile is a named
:class:`~dart_planner_tpu_torch.control.geometric.GeometricConfig` override
set: the functional controller consumes the config directly, so profiles
stay declarative and hashable.
"""

from __future__ import annotations

from typing import Dict

from dart_planner_tpu_torch.common.errors import ConfigurationError
from dart_planner_tpu_torch.control.geometric import GeometricConfig

DEFAULT_PROFILE = "sitl_optimized"


def _profile(description: str, **overrides) -> tuple[str, GeometricConfig]:
    return description, GeometricConfig()._replace(**overrides)


# name -> (description, config). The default GeometricConfig already carries
# the reference's transport-delay-retuned SITL gains, so "sitl_optimized"
# is the identity.
_PROFILES: Dict[str, tuple[str, GeometricConfig]] = {
    "sitl_optimized": _profile(
        "Retuned for 25 ms transport delay; SITL default "
        "(reference control_config.py sitl_optimized)",
    ),
    "conservative": _profile(
        "Stable, precise tracking for hardware/testing "
        "(reference control_config.py conservative)",
        kp_pos=(5.0, 5.0, 6.0),
        ki_pos=(0.2, 0.2, 0.4),
        kd_pos=(3.2, 3.2, 4.2),
        ff_pos=1.0,
        ff_vel=0.6,
        max_tilt_angle=0.7853981633974483,  # 45 deg
        tracking_error_threshold=1.0,
        velocity_error_threshold=0.5,
    ),
    "aggressive": _profile(
        "High-bandwidth gains for racing / aggressive maneuvers "
        "(reference control_config.py aggressive)",
        kp_pos=(11.0, 11.0, 13.0),
        ki_pos=(0.6, 0.6, 1.0),
        kd_pos=(6.0, 6.0, 7.5),
        kp_att=(14.0, 14.0, 6.0),
        kd_att=(4.5, 4.5, 2.2),
        ff_pos=1.4,
        ff_vel=1.0,
        tracking_error_threshold=3.0,
        velocity_error_threshold=2.0,
    ),
    "tracking_optimized": _profile(
        "Integral-heavy gains minimizing steady-state tracking error "
        "(reference control_config.py tracking_optimized)",
        ki_pos=(0.8, 0.8, 1.2),
        max_integral_pos=8.0,
        max_integral_per_axis=(3.0, 3.0, 4.0),
        ff_pos=1.3,
        ff_vel=0.9,
    ),
}

_RECOMMENDATIONS: Dict[str, str] = {
    "sitl": "sitl_optimized",
    "simulation": "sitl_optimized",
    "testing": "conservative",
    "hardware": "conservative",
    "precision": "conservative",
    "aggressive": "aggressive",
    "racing": "aggressive",
    "tracking": "tracking_optimized",
    "default": DEFAULT_PROFILE,
}


def get_controller_config(profile_name: str = DEFAULT_PROFILE) -> GeometricConfig:
    """Profile name -> GeometricConfig."""
    if profile_name not in _PROFILES:
        raise ConfigurationError(
            f"Unknown profile '{profile_name}'. Available: {list_profiles()}"
        )
    return _PROFILES[profile_name][1]


def list_profiles() -> Dict[str, str]:
    """name -> description."""
    return {name: desc for name, (desc, _) in _PROFILES.items()}


def add_custom_profile(
    name: str, config: GeometricConfig, description: str = ""
) -> None:
    """Register a custom profile."""
    _PROFILES[name] = (description or name, config)


def get_recommended_profile(scenario: str) -> str:
    """Scenario keyword -> profile name."""
    return _RECOMMENDATIONS.get(scenario.lower(), DEFAULT_PROFILE)
