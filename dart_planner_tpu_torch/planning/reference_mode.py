"""Reference-equivalence mode: the reference solver's outputs in closed form
(PyTorch counterpart of :mod:`dart_planner_tpu.planning.reference_mode`).

The reference solves a *separable* 9N-variable problem with L-BFGS-B using a
hand-written gradient that only contains the position-tracking,
velocity-regulation and ``w_T ||T||^2`` terms, and its equality "dynamics
constraints" are never enforced (a bounds-only method). Its converged output
is therefore the projection of that gradient field's roots:

    positions_k  = clip(goal, -100, 100)
    velocities_k = 0
    thrusts_k    = (0, 0, T_z)

for two gradient conventions:

- ``gradient="reference"``: bug-compatible with the hand-written gradient
  (the default; what the reference ships). Its thrust root is 0, but every
  step toward it is rejected by the line search on the objective, which is
  least at hover, so thrust stays at its hover initialization;
- ``gradient="exact"``: the true minimizer of the separable objective, also
  hover ``m g``.

The JAX package's golden fixtures (``tests/fixtures/golden``, recorded from
the reference under scipy) hold both.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dart_planner_tpu_torch.common.device import default_device
from dart_planner_tpu_torch.planning.se3_mpc import SE3MPCConfig

Tensor = torch.Tensor

POSITION_ENVELOPE = 100.0  # +-100 m flight envelope of the reference

GRADIENTS = ("reference", "exact")


class ReferenceSolution(NamedTuple):
    positions: Tensor  # (..., N, 3)
    velocities: Tensor  # (..., N, 3)
    thrust_vectors: Tensor  # (..., N, 3)


def solve_reference_mode(
    config: SE3MPCConfig,
    position,
    velocity,
    goal,
    gradient: str = "reference",
    device=None,
) -> ReferenceSolution:
    """Closed-form fixed point of the reference's L-BFGS-B iteration, on
    ``device`` (None: ``goal``'s device when it is a tensor, else the card).

    ``position``/``velocity`` are accepted for signature parity: the
    reference's initial state rows are decision variables whose anchoring
    equality constraints the bounds-only method ignores, so the converged
    solution does not depend on them."""
    if gradient not in GRADIENTS:
        raise ValueError(f"unknown gradient mode {gradient!r}")
    N = config.prediction_horizon
    if device is None:
        device = goal.device if isinstance(goal, Tensor) else default_device()
    goal = torch.as_tensor(goal, device=device)
    if not goal.dtype.is_floating_point:
        goal = goal.to(torch.float32)
    batch = tuple(goal.shape[:-1])
    kw = dict(dtype=goal.dtype, device=goal.device)

    pos_star = torch.clamp(goal, -POSITION_ENVELOPE, POSITION_ENVELOPE)
    positions = pos_star[..., None, :].expand(batch + (N, 3))
    velocities = torch.zeros(batch + (N, 3), **kw)
    # both conventions land on hover: the reference's by the rejected line
    # search, the exact one as the root of
    # d/dT_z [w_a (T/m - g)^2 + w_T (T - m g)^2]
    tz = config.mass * config.gravity
    tz = min(max(tz, config.min_thrust), config.max_thrust)
    thrust = torch.tensor([0.0, 0.0, tz], **kw)
    return ReferenceSolution(
        positions=positions,
        velocities=velocities,
        thrust_vectors=thrust.expand(batch + (N, 3)),
    )
