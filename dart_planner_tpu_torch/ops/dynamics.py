"""Quadrotor translational dynamics: sequential rollout + condensed linear
maps (PyTorch counterpart of :mod:`dart_planner_tpu.ops.dynamics`).

Thrust vectors ``u (..., N, 3)`` are the only decision variables; states
are affine in ``u``:

    v_k = v0 + S_v a              with  S_v[k, j] = dt              for j < k
    p_k = p0 + k dt v0 + S_p a    with  S_p[k, j] = dt^2 (k - j - 1/2) for j < k

where ``a = u / m + g_vec`` (``g_vec`` = (0, 0, -g) in ENU).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

Tensor = torch.Tensor


@functools.lru_cache(maxsize=32)
def rollout_matrices(N: int, dt: float) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Constant maps (S_p, S_v, t) in float64 numpy for horizon ``N``.

    Strictly lower triangular: state k depends on accelerations 0..k-1.
    """
    k = np.arange(N)[:, None]
    j = np.arange(N)[None, :]
    mask = (j < k).astype(np.float64)
    S_v = dt * mask
    S_p = (dt * dt) * (k - j - 0.5) * mask
    t = (dt * np.arange(N)).astype(np.float64)
    return S_p, S_v, t


def accel_from_thrust(u: Tensor, mass: float, gravity_vec: Tensor) -> Tensor:
    """a_k = u_k / m + g_vec."""
    return u / mass + gravity_vec


def apply_steps(M: Tensor, x: Tensor) -> Tensor:
    """(N, N) map over the horizon axis of (..., N, 3): ``M @ x`` per axis.

    Exact fp32 on the CPU, and on CUDA while
    ``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's default;
    the rollout, gradient and cost must not run in TF32)."""
    return torch.matmul(M, x)


def rollout_linear(
    u: Tensor,
    p0: Tensor,
    v0: Tensor,
    dt: float,
    mass: float,
    gravity_vec: Tensor,
) -> tuple[Tensor, Tensor, Tensor]:
    """Closed-form rollout: thrusts (..., N, 3) -> (positions, velocities,
    accelerations), each (..., N, 3)."""
    N = u.shape[-2]
    S_p, S_v, t = rollout_matrices(N, float(dt))
    kw = dict(dtype=u.dtype, device=u.device)
    S_p = torch.as_tensor(S_p, **kw)
    S_v = torch.as_tensor(S_v, **kw)
    t = torch.as_tensor(t, **kw)
    a = accel_from_thrust(u, mass, gravity_vec)
    vel = v0[..., None, :] + apply_steps(S_v, a)
    pos = p0[..., None, :] + t[:, None] * v0[..., None, :] + apply_steps(S_p, a)
    return pos, vel, a


def rollout_scan(
    u: Tensor,
    p0: Tensor,
    v0: Tensor,
    dt: float,
    mass: float,
    gravity_vec: Tensor,
) -> tuple[Tensor, Tensor, Tensor]:
    """Sequential rollout, one step at a time (same semantics as
    :func:`rollout_linear`): state k is emitted before a_k is applied."""
    a = accel_from_thrust(u, mass, gravity_vec)
    p, v = p0, v0
    ps, vs = [], []
    for k in range(u.shape[-2]):
        ps.append(p)
        vs.append(v)
        a_k = a[..., k, :]
        p = p + v * dt + 0.5 * a_k * dt * dt
        v = v + a_k * dt
    return torch.stack(ps, dim=-2), torch.stack(vs, dim=-2), a
