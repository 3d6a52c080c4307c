"""Extended Kalman filter for translational state, batched (PyTorch
counterpart of :mod:`dart_planner_tpu.estimation.ekf`).

A 9-state EKF (position, velocity, accelerometer bias) with a
constant-acceleration process model, for one vehicle or a fleet: every
field may carry leading batch dims, so a fleet's filter bank is one call
(where the JAX package ``vmap``s).

State x = [p (3), v (3), b_a (3)]; inputs are body-frame specific force
rotated to world by the known attitude (from the attitude loop) plus
gravity.

Precision: every matrix product is exact fp32 (:func:`_mm`, an
elementwise product and sum, never a matmul), whatever the process's TF32
settings; the JAX package asks for "highest" precision at the same places.
A TF32 product (about three decimal digits) drifts P off symmetric-PSD.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from dart_planner_tpu_torch.common.device import resolve_device
from dart_planner_tpu_torch.common.types import _Replace

Tensor = torch.Tensor


class EKFConfig(NamedTuple):
    accel_noise: float = 0.5  # m/s^2 process noise on acceleration
    bias_noise: float = 0.01  # random-walk on accel bias
    pos_meas_noise: float = 0.05  # m (e.g. mocap/GPS-RTK)
    vel_meas_noise: float = 0.1  # m/s


@dataclass
class EKFState(_Replace):
    x: Tensor  # (..., 9)
    P: Tensor  # (..., 9, 9)


def _mm(a: Tensor, b: Tensor) -> Tensor:
    """Exact fp32 product of (..., n, k) and (..., k, m) matrices."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _mv(a: Tensor, x: Tensor) -> Tensor:
    """Exact fp32 product of (..., n, k) matrices and (..., k) vectors."""
    return (a * x[..., None, :]).sum(-1)


def ekf_init(
    position,
    velocity=None,
    pos_var: float = 1.0,
    vel_var: float = 1.0,
    bias_var: float = 0.01,
    dtype=torch.float32,
    device=None,
) -> EKFState:
    """Filter state at ``position`` (..., 3). A tensor keeps its device
    unless ``device`` is given; anything else goes to ``device`` (default:
    the card)."""
    if device is None and isinstance(position, Tensor):
        device = position.device
    device = resolve_device(device)
    p = torch.as_tensor(position, dtype=dtype, device=device)
    v = (
        torch.as_tensor(velocity, dtype=dtype, device=device)
        if velocity is not None
        else torch.zeros_like(p)
    )
    batch = p.shape[:-1]
    x = torch.cat([p, v, torch.zeros_like(p)], dim=-1)
    diag = torch.tensor(
        [pos_var] * 3 + [vel_var] * 3 + [bias_var] * 3, dtype=dtype, device=device
    )
    P = torch.diag(diag).expand(batch + (9, 9)).clone()
    return EKFState(x=x, P=P)


def _blocks(rows, like: Tensor) -> Tensor:
    """A 9x9 matrix from a 3x3 grid of 3x3 blocks (each a scalar times I)."""
    eye3 = torch.eye(3, dtype=like.dtype, device=like.device)
    return torch.cat(
        [torch.cat([eye3 * c for c in row], dim=1) for row in rows], dim=0
    )


def ekf_predict(config: EKFConfig, state: EKFState, accel_world, dt) -> EKFState:
    """Propagate with measured world-frame acceleration (bias-corrected)."""
    x = state.x
    a_w = torch.as_tensor(accel_world, dtype=x.dtype, device=x.device)
    dt = float(dt)
    p, v, b = x[..., 0:3], x[..., 3:6], x[..., 6:9]
    a = a_w - b
    p2 = p + v * dt + 0.5 * a * dt * dt
    v2 = v + a * dt
    x2 = torch.cat([p2, v2, b], dim=-1)

    # F = d(x2)/d(x): p depends on v (dt) and b (-dt^2/2); v on b (-dt)
    F = _blocks([[1.0, dt, -0.5 * dt * dt], [0.0, 1.0, -dt], [0.0, 0.0, 1.0]], x)
    qa = config.accel_noise**2
    qb = config.bias_noise**2
    # discrete white-noise-acceleration Q
    Q = _blocks(
        [
            [qa * dt**4 / 4, qa * dt**3 / 2, 0.0],
            [qa * dt**3 / 2, qa * dt**2, 0.0],
            [0.0, 0.0, qb * dt],
        ],
        x,
    )
    P2 = _mm(_mm(F, state.P), F.T) + Q
    return EKFState(x=x2, P=P2)


def _kalman_update(state: EKFState, H: Tensor, z: Tensor, R: Tensor) -> EKFState:
    y = z - _mv(H, state.x)
    HT = H.T
    S = _mm(_mm(H, state.P), HT) + R
    K = _mm(_mm(state.P, HT), torch.linalg.inv(S))
    x2 = state.x + _mv(K, y)
    eye = torch.eye(state.x.shape[-1], dtype=state.x.dtype, device=state.x.device)
    P2 = _mm(eye - _mm(K, H), state.P)
    return EKFState(x=x2, P=P2)


def _selector(offset: int, like: Tensor) -> Tensor:
    """(3, 9): picks the three states from ``offset``."""
    H = torch.zeros(3, 9, dtype=like.dtype, device=like.device)
    H[:, offset:offset + 3] = torch.eye(3, dtype=like.dtype, device=like.device)
    return H


def ekf_update_position(config: EKFConfig, state: EKFState, pos_meas) -> EKFState:
    x = state.x
    R = torch.eye(3, dtype=x.dtype, device=x.device) * config.pos_meas_noise**2
    z = torch.as_tensor(pos_meas, dtype=x.dtype, device=x.device)
    return _kalman_update(state, _selector(0, x), z, R)


def ekf_update_velocity(config: EKFConfig, state: EKFState, vel_meas) -> EKFState:
    x = state.x
    R = torch.eye(3, dtype=x.dtype, device=x.device) * config.vel_meas_noise**2
    z = torch.as_tensor(vel_meas, dtype=x.dtype, device=x.device)
    return _kalman_update(state, _selector(3, x), z, R)
