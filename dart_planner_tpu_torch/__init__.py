"""DART-Planner on PyTorch and CUDA: the SE(3) MPC solve for NVIDIA Hopper.

A port of :mod:`dart_planner_tpu` (the JAX/Pallas package, which stays the
reference) with the same module layout:

- ``common/``   types, frames, errors
- ``ops/``      condensed dynamics, cost model, SO(3) operators, and the
  hand-written CUDA solver kernel (``ops/cuda_mpc.py`` over
  ``csrc/mpc_solve.cu``)
- ``planning/`` the batched two-phase projected-Newton solve, planner
  facade and registry
- ``runtime/``  the planner-to-actuator fast path and the C++ RT executor
  bindings

``planning.se3_mpc.solve(..., method="auto")`` runs the CUDA kernel when the
problem's tensors are on a GPU and the plain PyTorch Newton loop when they
are on the CPU. This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"

from dart_planner_tpu_torch.common.types import (
    BodyRateCommand,
    ControlCommand,
    DroneState,
    Trajectory,
)

__all__ = [
    "ControlCommand",
    "BodyRateCommand",
    "DroneState",
    "Trajectory",
    "__version__",
]
