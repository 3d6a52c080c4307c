"""ENU / NED world frames (PyTorch counterpart of
:mod:`dart_planner_tpu.common.frames`, the part the solver needs).

Gravity-vector sign consistency is the load-bearing behavior: the solver's
accelerations are ``u / m + gravity_vector``.
"""

from __future__ import annotations

import enum

import torch

GRAVITY_MAGNITUDE = 9.81  # m/s^2


class WorldFrame(str, enum.Enum):
    ENU = "ENU"  # x east, y north, z up
    NED = "NED"  # x north, y east, z down


def gravity_vector(
    frame: WorldFrame = WorldFrame.ENU,
    magnitude: float = GRAVITY_MAGNITUDE,
    dtype=torch.float32,
    device="cpu",
) -> torch.Tensor:
    """Gravity acceleration in the given world frame: ENU (0, 0, -g),
    NED (0, 0, +g)."""
    sign = -1.0 if frame == WorldFrame.ENU else 1.0
    return torch.tensor([0.0, 0.0, sign * magnitude], dtype=dtype, device=device)
