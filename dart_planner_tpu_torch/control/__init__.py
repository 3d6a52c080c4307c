"""Geometric SE(3) control and its tuning profiles (PyTorch counterpart of
:mod:`dart_planner_tpu.control`; the smoother and the onboard controller are
not ported yet)."""

from dart_planner_tpu_torch.control.geometric import (
    ControllerState,
    GeometricConfig,
    GeometricController,
    compute_control,
)
from dart_planner_tpu_torch.control.tuning_profiles import (
    add_custom_profile,
    get_controller_config,
    get_recommended_profile,
    list_profiles,
)

__all__ = [
    "ControllerState",
    "GeometricConfig",
    "GeometricController",
    "compute_control",
    "add_custom_profile",
    "get_controller_config",
    "get_recommended_profile",
    "list_profiles",
]
