"""ENU / NED world frames (PyTorch counterpart of
:mod:`dart_planner_tpu.common.frames`): frozen transform constants and a
small thread-local frame manager.

Gravity-vector sign consistency is the load-bearing behavior: the solver's
accelerations are ``u / m + gravity_vector``. The default world frame is ENU
(z up).
"""

from __future__ import annotations

import enum
import threading

import numpy as np
import torch

from dart_planner_tpu_torch.common.device import resolve_device

GRAVITY_MAGNITUDE = 9.81  # m/s^2


class WorldFrame(str, enum.Enum):
    ENU = "ENU"  # x east, y north, z up
    NED = "NED"  # x north, y east, z down


# ENU <-> NED: swap x/y, negate z. The matrix is its own inverse.
ENU_TO_NED = np.array(
    [[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, -1.0]], dtype=np.float64
)
NED_TO_ENU = ENU_TO_NED.T  # == ENU_TO_NED


def gravity_vector(
    frame: WorldFrame = WorldFrame.ENU,
    magnitude: float = GRAVITY_MAGNITUDE,
    dtype=torch.float32,
    device=None,
) -> torch.Tensor:
    """Gravity acceleration in the given world frame: ENU (0, 0, -g),
    NED (0, 0, +g), on ``device`` (default: the card)."""
    sign = -1.0 if frame == WorldFrame.ENU else 1.0
    return torch.tensor([0.0, 0.0, sign * magnitude], dtype=dtype,
                        device=resolve_device(device))


def up_vector(frame: WorldFrame = WorldFrame.ENU, dtype=torch.float32,
              device=None) -> torch.Tensor:
    """The world's up direction: ENU (0, 0, 1), NED (0, 0, -1)."""
    sign = 1.0 if frame == WorldFrame.ENU else -1.0
    return torch.tensor([0.0, 0.0, sign], dtype=dtype, device=resolve_device(device))


def enu_to_ned(v: torch.Tensor) -> torch.Tensor:
    """Vectors (..., 3) from ENU to NED (on their own device): swap x/y,
    negate z."""
    flip = torch.tensor([1.0, 1.0, -1.0], dtype=v.dtype, device=v.device)
    return v[..., [1, 0, 2]] * flip


def ned_to_enu(v: torch.Tensor) -> torch.Tensor:
    """Vectors (..., 3) from NED to ENU: the same map, its own inverse."""
    return enu_to_ned(v)


class CoordinateFrameManager:
    """Thread-local frame context for multi-sim tests; its vectors are made
    on ``device`` (default: the card)."""

    _local = threading.local()

    def __init__(self, frame: WorldFrame = WorldFrame.ENU, device=None):
        self.world_frame = frame
        self.device = device

    def get_gravity_vector(self, magnitude: float = GRAVITY_MAGNITUDE) -> torch.Tensor:
        return gravity_vector(self.world_frame, magnitude, device=self.device)

    def get_up_vector(self) -> torch.Tensor:
        return up_vector(self.world_frame, device=self.device)

    def __enter__(self):
        self._prev = getattr(self._local, "manager", None)
        self._local.manager = self
        return self

    def __exit__(self, *exc):
        self._local.manager = self._prev
        return False


def get_coordinate_frame_manager() -> CoordinateFrameManager:
    """The calling thread's manager (an ENU one is made on first use)."""
    mgr = getattr(CoordinateFrameManager._local, "manager", None)
    if mgr is None:
        mgr = CoordinateFrameManager()
        CoordinateFrameManager._local.manager = mgr
    return mgr
