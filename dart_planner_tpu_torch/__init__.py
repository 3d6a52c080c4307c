"""DART-Planner on PyTorch and CUDA: the SE(3) MPC solve, the closed-loop
Monte-Carlo, the three-layer mission stack, the edge<->cloud deployment and
the system's front door (the frozen configuration, the CLI, the DI
container and the web demo) for NVIDIA Hopper.

A port of :mod:`dart_planner_tpu` (the JAX/Pallas package, which stays the
reference) with the same module layout:

- ``common/``     types, frames, errors, the default device, runtime
  metrics, logging, timing alignment, the vector PID, the DI container,
  SI units, the versioned state buffers and retry / circuit breakers
- ``config/``     the frozen configuration (YAML + ``DART_*`` overrides),
  vehicle parameters and airframe presets
- ``ops/``        condensed dynamics, cost model, SO(3) operators, and the
  hand-written CUDA kernels: the solver (``ops/cuda_mpc.py`` over
  ``csrc/mpc_solve.cu``) and the closed-loop tick block
  (``ops/cuda_rollout.py`` over ``csrc/tick_block.cu``)
- ``planning/``   the batched two-phase projected-Newton solve, planner
  facade and registry (L2), and the global mission planner (L1)
- ``control/``    the geometric SE(3) controller, the trajectory smoother
  and the onboard PID fallback (L3)
- ``sim/``        rigid-body physics, closed-loop episodes, obstacle worlds,
  the BASELINE scenario library and the resumable Monte-Carlo sweep
- ``parallel/``   the scenario fleet over a grid of devices and processes
  (``torch.distributed``)
- ``perception/`` the log-odds voxel mapper
- ``neural_scene/`` the placeholder scene grids and the exploration
  uncertainty field
- ``estimation/`` the batched EKF and the estimator adapters
- ``security/``   input validation
- ``hardware/``   the vehicle I/O, the simulated vehicle, the motor model
  and mixer, the mission runner, the safety manager and watchdog, and the
  transport-delay buffer
- ``runtime/``    the planner-to-actuator fast path, the C++ RT executor
  bindings, the asyncio scheduler and the real-time integration layer
- ``comms/``      the edge<->cloud boundary: the signed serializer (the
  JAX package's wire format), the ZMQ transport, the heartbeat and
  telemetry compression
- ``apps/``       the ``dart-planner-tpu-torch`` CLI, the three-layer
  cloud, the edge control loop, the onboard autonomous controller, the
  minimal takeoff and the browser demo

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
