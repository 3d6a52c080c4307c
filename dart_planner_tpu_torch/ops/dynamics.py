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

from dart_planner_tpu_torch.ops.device_constants import device_constant

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


def _maps_on(N: int, dt: float, *, dtype, device) -> tuple[Tensor, Tensor, Tensor]:
    return tuple(torch.as_tensor(m, dtype=dtype, device=device)
                 for m in rollout_matrices(N, dt))


def rollout_maps(N: int, dt: float, dtype, device) -> tuple[Tensor, Tensor, Tensor]:
    """(S_p, S_v, t) of :func:`rollout_matrices` cast to ``dtype`` on
    ``device``, made there once (:mod:`.device_constants`; read only)."""
    return device_constant(_maps_on, N, float(dt), dtype=dtype, device=device)


def _scaled_maps_on(N: int, dt: float, mass: float, *, dtype, device) -> tuple[Tensor, Tensor]:
    S_p, S_v, _ = rollout_maps(N, dt, dtype, device)
    return S_p / mass, S_v / mass


def scaled_maps(N: int, dt: float, mass: float, dtype, device) -> tuple[Tensor, Tensor]:
    """(S_p / m, S_v / m): the maps of :func:`rollout_maps` divided by the
    mass on ``device`` in ``dtype``, made there once (read only)."""
    return device_constant(_scaled_maps_on, N, float(dt), float(mass), dtype=dtype,
                           device=device)


def _exclusive_prefix(x: Tensor) -> Tensor:
    """sum_{j<k} x_j over the horizon axis of (..., N, 3)."""
    c = torch.cumsum(x, dim=-2)
    return torch.cat([torch.zeros_like(c[..., :1, :]), c[..., :-1, :]], dim=-2)


def _exclusive_suffix(x: Tensor) -> Tensor:
    """sum_{j>k} x_j over the horizon axis of (..., N, 3)."""
    return _exclusive_prefix(x.flip(-2)).flip(-2)


STRUCTURED_MAPS = ("S_p", "S_v", "S_p^T", "S_v^T")


def apply_structured(kind: str, x: Tensor, dt: float) -> Tensor:
    """``M @ x`` over the horizon axis of (..., N, 3) for M one of
    :data:`STRUCTURED_MAPS`, by prefix or suffix sums in place of the dense
    maps of :func:`rollout_matrices`. With E the exclusive prefix sum,
    ``S_v x = dt E(x)`` and ``S_p x = dt^2 (E(x) / 2 + E(E(x)))``; the
    transposes are the same with the exclusive suffix sum. The CUDA solver
    kernel applies the maps by these identities, as warp scans."""
    if kind not in STRUCTURED_MAPS:
        raise ValueError(f"kind must be one of {STRUCTURED_MAPS}, got {kind!r}")
    scan = _exclusive_suffix if kind.endswith("^T") else _exclusive_prefix
    e = scan(x)
    if kind.startswith("S_v"):
        return dt * e
    return (dt * dt) * (0.5 * e + scan(e))


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
    S_p, S_v, t = rollout_maps(u.shape[-2], dt, u.dtype, u.device)
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


def simulator_step(
    pos: Tensor,
    vel: Tensor,
    att: Tensor,
    ang_vel: Tensor,
    thrust: Tensor,
    torque: Tensor,
    dt: float,
    mass: float = 1.5,
    gravity: float = 9.81,
    inertia_diag: Tensor | None = None,
    wind: Tensor | None = None,
    thrust_along_body_z: bool = False,
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """One Euler step of the point-mass + rigid-rotation simulator.

    ``thrust_along_body_z=False`` reproduces the reference
    ``DroneSimulator.step``: thrust acts along *world* z, semi-implicit
    Euler (velocity first, then position with the new velocity). With
    ``True`` the thrust acts along the body z-axis (full SE(3) model)."""
    from dart_planner_tpu_torch.ops.so3 import euler_to_rotmat

    kw = dict(dtype=pos.dtype, device=pos.device)
    if inertia_diag is None:
        inertia_diag = torch.tensor([0.1, 0.1, 0.2], **kw)
    if wind is None:
        wind = torch.zeros(3, **kw)
    e3 = torch.tensor([0.0, 0.0, 1.0], **kw).expand(pos.shape)
    thrust_dir = euler_to_rotmat(att)[..., :, 2] if thrust_along_body_z else e3
    acc = -gravity * e3 + thrust[..., None] / mass * thrust_dir + wind / mass
    new_vel = vel + acc * dt
    new_pos = pos + new_vel * dt
    new_ang_vel = ang_vel + torque / inertia_diag * dt
    new_att = att + new_ang_vel * dt
    return new_pos, new_vel, new_att, new_ang_vel
