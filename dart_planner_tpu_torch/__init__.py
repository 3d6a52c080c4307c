"""DART-Planner on PyTorch and CUDA: the SE(3) MPC solve and the closed-loop
Monte-Carlo for NVIDIA Hopper.

A port of :mod:`dart_planner_tpu` (the JAX/Pallas package, which stays the
reference) with the same module layout:

- ``common/``     types, frames, errors, the default device, runtime metrics
- ``ops/``        condensed dynamics, cost model, SO(3) operators, and the
  hand-written CUDA kernels: the solver (``ops/cuda_mpc.py`` over
  ``csrc/mpc_solve.cu``) and the closed-loop tick block
  (``ops/cuda_rollout.py`` over ``csrc/tick_block.cu``)
- ``planning/``   the batched two-phase projected-Newton solve, planner
  facade and registry
- ``control/``    the geometric SE(3) controller
- ``sim/``        rigid-body physics, closed-loop episodes, obstacle worlds,
  the BASELINE scenario library and the resumable Monte-Carlo sweep
- ``parallel/``   the scenario fleet over a grid of devices and processes
  (``torch.distributed``)
- ``perception/`` the log-odds voxel mapper
- ``runtime/``    the planner-to-actuator fast path and the C++ RT executor
  bindings

``planning.se3_mpc.solve(..., method="auto")`` and
``sim.closed_loop.simulate_episode(..., method="auto")`` run the CUDA
kernels when their tensors are on a GPU and the plain PyTorch versions when
they are on the CPU. This package imports ``torch`` and never ``jax``.
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
