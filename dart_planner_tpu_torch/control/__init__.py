"""L3 geometric SE(3) control, tuning profiles, trajectory smoothing and the
onboard PID fallback (PyTorch counterpart of :mod:`dart_planner_tpu.control`)."""

from dart_planner_tpu_torch.control.geometric import (
    ControllerState,
    GeometricConfig,
    GeometricController,
    compute_control,
)
from dart_planner_tpu_torch.control.onboard import OnboardController
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
    "OnboardController",
    "compute_control",
    "add_custom_profile",
    "get_controller_config",
    "get_recommended_profile",
    "list_profiles",
]
