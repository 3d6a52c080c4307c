"""Lightweight SI-unit discipline at API boundaries (PyTorch counterpart
of :mod:`dart_planner_tpu.common.units`).

The reference uses a pint ``UnitRegistry`` (its common/units.py:24-107)
and then bypasses it in every hot loop. The port keeps one rule: *all
tensors are base SI*, and boundary code may annotate/validate with these
helpers, which work on host values (numpy). A tensor, on any device, is
read to the host once through
:func:`~dart_planner_tpu_torch.common.device.to_host`.
"""

from __future__ import annotations

from typing import Iterable, Union

import numpy as np
import torch

from dart_planner_tpu_torch.common.device import to_host

# Canonical dimensions used across the stack, for documentation + validation.
SI_UNITS = {
    "position": "m",
    "velocity": "m/s",
    "acceleration": "m/s^2",
    "jerk": "m/s^3",
    "attitude": "rad",
    "angular_velocity": "rad/s",
    "thrust": "N",
    "torque": "N*m",
    "mass": "kg",
    "time": "s",
}

_CONVERSIONS = {
    # (from_unit, to_si_unit) -> multiplier
    ("km", "m"): 1000.0,
    ("cm", "m"): 0.01,
    ("mm", "m"): 0.001,
    ("ft", "m"): 0.3048,
    ("deg", "rad"): np.pi / 180.0,
    ("deg/s", "rad/s"): np.pi / 180.0,
    ("km/h", "m/s"): 1.0 / 3.6,
    ("g", "m/s^2"): 9.80665,
    ("ms", "s"): 1e-3,
    ("us", "s"): 1e-6,
    ("kgf", "N"): 9.80665,
}


class UnitError(ValueError):
    """Raised when a boundary value fails unit validation."""


def _host(value, dtype=None) -> np.ndarray:
    """``value`` on the host: a tensor copied once (keeping its dtype unless
    ``dtype`` is given), anything else through ``np.asarray``."""
    if isinstance(value, torch.Tensor):
        return to_host(value, dtype or str(value.dtype).removeprefix("torch."))
    return np.asarray(value, dtype)


def to_si(value: Union[float, Iterable], unit: str, si_unit: str):
    """Convert ``value`` expressed in ``unit`` into base SI ``si_unit``."""
    if unit == si_unit:
        return _host(value)
    key = (unit, si_unit)
    if key not in _CONVERSIONS:
        raise UnitError(f"No conversion from {unit!r} to {si_unit!r}")
    return _host(value) * _CONVERSIONS[key]


def ensure_si(value, kind: str, name: str = "value"):
    """Validate a boundary value for dimension ``kind`` (shape/finite checks).

    Mirrors the *intent* of reference ``ensure_units`` (units.py:80-107)
    without a unit type: checks the array is numeric, finite, and (for vector
    kinds) has a trailing dimension of 3.
    """
    if kind not in SI_UNITS:
        raise UnitError(f"Unknown unit kind {kind!r} for {name}")
    arr = _host(value, np.float64)
    if not np.all(np.isfinite(arr)):
        raise UnitError(f"{name} ({kind}) contains non-finite values")
    vector_kinds = {
        "position",
        "velocity",
        "acceleration",
        "jerk",
        "attitude",
        "angular_velocity",
        "torque",
    }
    if kind in vector_kinds and (arr.ndim == 0 or arr.shape[-1] != 3):
        raise UnitError(
            f"{name} ({kind}) must have trailing dim 3, got shape {arr.shape}"
        )
    return arr
