"""State estimation (PyTorch counterpart of :mod:`dart_planner_tpu.estimation`):
adapters that standardize external estimator outputs into
``EstimatedState`` (PX4 EKF2 via MAVLink, simulator ground-truth shim), and a
batched extended Kalman filter for fleets of simulated vehicles with noisy
sensors."""

from dart_planner_tpu_torch.estimation.adapters import (
    PX4EKF2StateEstimator,
    SimGroundTruthEstimator,
)
from dart_planner_tpu_torch.estimation.ekf import (
    EKFConfig,
    EKFState,
    ekf_init,
    ekf_predict,
    ekf_update_position,
    ekf_update_velocity,
)

__all__ = [
    "PX4EKF2StateEstimator",
    "SimGroundTruthEstimator",
    "EKFConfig",
    "EKFState",
    "ekf_init",
    "ekf_predict",
    "ekf_update_position",
    "ekf_update_velocity",
]
