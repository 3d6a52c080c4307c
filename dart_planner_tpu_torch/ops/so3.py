"""SO(3) operators: hat/vee, Euler/quaternion rotations, thrust-frame
construction, and body-rate extraction (PyTorch counterpart of
:mod:`dart_planner_tpu.ops.so3`).

Branch-free and batched over any leading dims: singularities are handled
with ``torch.where`` masks. Every rotation product goes through :func:`mm`,
which stays exact fp32 whatever the TF32 settings are.

Convention: Euler angles are (roll, pitch, yaw) with
R = Rz(yaw) @ Ry(pitch) @ Rx(roll) (ZYX).
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

_EPS = 1e-6


def mm(a: Tensor, b: Tensor) -> Tensor:
    """Exact fp32 product of (..., 3, 3) matrices.

    An elementwise product and sum, never a matmul: on a GPU a float32
    matmul may run in TF32 (about three decimal digits), and a closed loop
    chains thousands of rotation increments."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _stack_rows(rows) -> Tensor:
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _unit(v: Tensor, axis: int) -> Tensor:
    e = torch.zeros_like(v)
    e[..., axis] = 1.0
    return e


def hat(v: Tensor) -> Tensor:
    """R^3 -> so(3): v -> [v]_x skew matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return _stack_rows([[zero, -z, y], [z, zero, -x], [-y, x, zero]])


def vee(m: Tensor) -> Tensor:
    """Inverse of :func:`hat`."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def euler_to_rotmat(euler: Tensor) -> Tensor:
    """(roll, pitch, yaw) -> R in SO(3), ZYX convention."""
    roll, pitch, yaw = euler[..., 0], euler[..., 1], euler[..., 2]
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    return _stack_rows(
        [
            [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr],
        ]
    )


def rotmat_to_euler(R: Tensor) -> Tensor:
    """R -> (roll, pitch, yaw), inverse of :func:`euler_to_rotmat`."""
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    pitch = torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([roll, pitch, yaw], dim=-1)


def quat_to_rotmat(q: Tensor) -> Tensor:
    """(w, x, y, z) quaternion -> R; non-normalized input is normalized,
    near-zero quaternions map to identity."""
    norm = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    safe = norm > _EPS
    qn = torch.where(
        safe, q / torch.where(safe, norm, torch.ones_like(norm)),
        torch.zeros_like(q),
    )
    w, x, y, z = qn[..., 0], qn[..., 1], qn[..., 2], qn[..., 3]
    R = _stack_rows(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
    eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(R.shape)
    return torch.where(safe[..., None], R, eye)


def normalize(v: Tensor, fallback: Tensor | None = None) -> Tensor:
    """Safe normalize: ||v|| < eps falls back to ``fallback`` (default e1)."""
    if fallback is None:
        fallback = _unit(v, 0)
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    safe = n > _EPS
    return torch.where(safe, v / torch.where(safe, n, torch.ones_like(n)), fallback)


def thrust_yaw_to_rotmat(thrust_vec: Tensor, yaw: Tensor) -> Tensor:
    """Desired attitude from a world-frame thrust vector and yaw angle:

        b3 = thrust / ||thrust||,  c = (cos yaw, sin yaw, 0)
        b1 = normalize(c x b3);  b2 = b3 x b1;  R = [b1 b2 b3]

    Near-zero thrust -> identity; c nearly parallel to b3 -> b1 from
    projecting whichever of e1/e2 is less aligned with b3.
    """
    tmag = torch.linalg.vector_norm(thrust_vec, dim=-1, keepdim=True)
    thrust_ok = tmag > _EPS
    b3 = torch.where(
        thrust_ok,
        thrust_vec / torch.where(thrust_ok, tmag, torch.ones_like(tmag)),
        _unit(thrust_vec, 2),
    )
    c = torch.stack([torch.cos(yaw), torch.sin(yaw), torch.zeros_like(yaw)], dim=-1)
    b1_raw = torch.linalg.cross(c, b3, dim=-1)
    b1_norm = torch.linalg.vector_norm(b1_raw, dim=-1, keepdim=True)
    e1 = _unit(b3, 0)
    e2 = _unit(b3, 1)
    use_e2 = b3[..., 0:1].abs() > 0.9
    axis = torch.where(use_e2, e2, e1)
    proj = axis - (axis * b3).sum(-1, keepdim=True) * b3
    b1_fallback = normalize(proj, fallback=e1)
    cross_ok = b1_norm > _EPS
    b1 = torch.where(
        cross_ok,
        b1_raw / torch.where(cross_ok, b1_norm, torch.ones_like(b1_norm)),
        b1_fallback,
    )
    b2 = torch.linalg.cross(b3, b1, dim=-1)
    R = torch.stack([b1, b2, b3], dim=-1)  # columns are b1, b2, b3
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand(R.shape)
    return torch.where(thrust_ok[..., None], R, eye)


def attitude_error(R: Tensor, R_des: Tensor) -> Tensor:
    """Geometric attitude error e_R = 0.5 * vee(R_d^T R - R^T R_d)."""
    Rd_T_R = mm(R_des.transpose(-1, -2), R)
    return 0.5 * vee(Rd_T_R - Rd_T_R.transpose(-1, -2))


def body_rates_from_rotmats(Rs: Tensor, dt) -> Tensor:
    """Finite-difference body rates omega_k = vee(R_k^T (R_k - R_{k-1}) / dt)
    along (..., N, 3, 3) rotations; the first step is zero."""
    R_prev = torch.cat([Rs[..., :1, :, :], Rs[..., :-1, :, :]], dim=-3)
    R_dot = (Rs - R_prev) / dt
    omega = vee(mm(Rs.transpose(-1, -2), R_dot))
    omega = omega.clone()
    omega[..., 0, :] = 0.0
    return omega


def exp_so3(w: Tensor) -> Tensor:
    """SO(3) exponential by Rodrigues' formula, Taylor-safe near zero."""
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2)
    small = theta < 1e-5
    one = torch.ones_like(theta)
    a = torch.where(small, 1.0 - theta2 / 6.0,
                    torch.sin(theta) / torch.where(small, one, theta))
    b = torch.where(
        small, 0.5 - theta2 / 24.0,
        (1.0 - torch.cos(theta)) / torch.where(small, one, theta2),
    )
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * mm(W, W)


def log_so3(R: Tensor) -> Tensor:
    """SO(3) logarithm (inverse of :func:`exp_so3`), safe near identity
    and near pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    skew = vee(R - R.transpose(-1, -2))  # = 2 sin(theta) * axis
    small = theta < 1e-5
    one = torch.ones_like(theta)
    scale = torch.where(
        small,
        0.5 + theta * theta / 12.0,
        theta / torch.where(small, one, 2.0 * torch.sin(torch.where(small, one, theta))),
    )
    w = scale[..., None] * skew
    near_pi = theta > math.pi - 1e-3
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis2 = torch.clamp(
        (diag - cos_theta[..., None]) / (1.0 - cos_theta[..., None] + 1e-12),
        min=0.0,
    )
    axis = torch.sqrt(axis2)

    def sgn(x):
        return torch.where(x >= 0, one, -one)

    signs = torch.stack(
        [sgn(R[..., 2, 1] - R[..., 1, 2]), sgn(R[..., 0, 2] - R[..., 2, 0]),
         sgn(R[..., 1, 0] - R[..., 0, 1])],
        dim=-1,
    )
    w_pi = theta[..., None] * axis * signs
    return torch.where(near_pi[..., None], w_pi, w)
