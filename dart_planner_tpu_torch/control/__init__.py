"""Geometric SE(3) control (PyTorch counterpart of
:mod:`dart_planner_tpu.control`; the tuning profiles, smoother and onboard
controller are not ported yet)."""

from dart_planner_tpu_torch.control.geometric import (
    ControllerState,
    GeometricConfig,
    GeometricController,
    compute_control,
)

__all__ = [
    "ControllerState",
    "GeometricConfig",
    "GeometricController",
    "compute_control",
]
