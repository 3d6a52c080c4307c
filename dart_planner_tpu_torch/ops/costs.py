"""SE(3) MPC cost model (PyTorch counterpart of
:mod:`dart_planner_tpu.ops.costs`).

    J(u) = sum_k  w_p ||p_k - goal||^2                (position tracking)
         + sum_k  w_v ||v_k||^2                       (velocity regulation)
         + sum_k  w_a ||a_k||^2                       (smoothness)
         + sum_k  w_T ||u_k - h e3||^2                (control effort, h = m g)
         + w_term w_p ||p_{N-1} - goal||^2            (terminal)
         + w_obs sum_{k,o} relu(r_safe_o - d_ko)^2    (obstacle hinge)
         + ground / velocity-envelope / tilt-cone / thrust-norm hinges

with (p, v, a) the affine functions of u from :mod:`.dynamics`. The
gradient is analytic (:func:`condensed_grad`), the same expression the
fused solver kernel evaluates; nothing differentiates through the solver.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from dart_planner_tpu_torch.ops import dynamics
from dart_planner_tpu_torch.ops.device_constants import device_constant, vector

Tensor = torch.Tensor


class CostWeights(NamedTuple):
    """Static cost weights (python floats)."""

    position: float = 100.0
    velocity: float = 10.0
    acceleration: float = 1.0
    thrust: float = 0.1
    terminal: float = 10.0  # multiplier on position weight at the last step
    obstacle: float = 1000.0
    ground: float = 0.0  # ground-clearance hinge weight (0 = off)
    ground_altitude: float = 0.0  # min altitude z_min for the hinge
    velocity_bound: float = 0.0  # per-axis |v| <= v_max hinge weight (0 = off)
    max_velocity: float = 0.0  # v_max for the hinge
    tilt: float = 0.0  # relu(||u_xy|| - tan_max_tilt * u_z)^2 weight
    tan_max_tilt: float = 0.0
    thrust_norm: float = 0.0  # relu(||u|| - max_thrust_norm)^2 weight
    max_thrust_norm: float = 0.0


class Problem(NamedTuple):
    """Per-scenario MPC problem data (tensors on one device)."""

    p0: Tensor  # (..., 3) current position
    v0: Tensor  # (..., 3) current velocity
    goal: Tensor  # (..., 3) goal point, or (..., N, 3) per-step reference
    obstacles: Tensor  # (..., K, 4): cx, cy, cz, r_safe (radius + margin)
    # (..., K) bool; where every scenario has the same mask, one (K,) row
    # expanded over the batch (:func:`batch_shared`)
    obstacle_mask: Tensor
    # optional per-scenario velocity cap (...,) replacing the static
    # ``CostWeights.max_velocity`` in the velocity-envelope hinge
    v_cap: Optional[Tensor] = None


def batch_shared(x: Tensor, dims: int) -> bool:
    """Whether the leading ``dims`` (batch) dims of ``x`` hold one row for
    the whole batch: each of size 1 or stride 0, as a row expanded over the
    batch is. Read from shapes and strides, with no tensor operation. Such a
    field stays shared where a batch is compacted, and kernel B1 takes a
    batch whose sphere mask is shared in its own order, every key being
    equal (``cuda_mpc.order_mask``)."""
    return all(n == 1 or s == 0 for n, s in zip(x.shape[:dims], x.stride()[:dims]))


def effective_vmax(prob: Problem, weights: CostWeights):
    """Velocity-envelope cap: per-scenario ``prob.v_cap`` (broadcast over
    horizon and axis dims) when present, else the static weight."""
    if prob.v_cap is None:
        return weights.max_velocity
    return prob.v_cap[..., None, None]


def _hover(u: Tensor, mass: float, gravity_vec: Tensor) -> Tensor:
    """m |g| e3 from the signed gravity vector: e3 is made on ``u``'s device
    once (:mod:`.device_constants`), the product is a device op, so the
    call neither uploads nor waits."""
    e3 = vector((0.0, 0.0, 1.0), u.dtype, u.device)
    return e3 * (mass * gravity_vec[2].abs())


def _goal_steps(prob: Problem) -> Tensor:
    """Goal broadcastable against (..., N, 3): a single point gains a
    horizon axis. Per-step iff goal has one more axis than p0 (p0's rank is
    the true batch rank; positions may carry extra candidate axes)."""
    goal = prob.goal
    if goal.ndim != prob.p0.ndim + 1:
        goal = goal[..., None, :]
    return goal


def _obstacle_geometry(pos: Tensor, obstacles: Tensor):
    """(diff, d, r_safe) for positions (..., N, 3) vs spheres (..., K, 4):
    diff (..., N, K, 3), softened distance d (..., N, K)."""
    centers = obstacles[..., :3]
    r_safe = obstacles[..., 3]
    diff = pos[..., :, None, :] - centers[..., None, :, :]
    d = torch.sqrt((diff * diff).sum(-1) + 1e-9)
    return diff, d, r_safe[..., None, :]


def obstacle_penalty(pos: Tensor, obstacles: Tensor, mask: Tensor) -> Tensor:
    """Smooth hinge penalty sum_{k,o} relu(r_safe - d)^2 -> (...)."""
    _, d, r_safe = _obstacle_geometry(pos, obstacles)
    viol = torch.clamp(r_safe - d, min=0.0)
    viol = viol * mask[..., None, :].to(viol.dtype)
    return (viol * viol).sum((-1, -2))


def condensed_cost(
    u: Tensor,
    prob: Problem,
    weights: CostWeights,
    dt: float,
    mass: float,
    gravity_vec: Tensor,
) -> Tensor:
    """Total cost J(u) for thrusts ``u`` (..., N, 3). Returns (...)."""
    pos, vel, acc = dynamics.rollout_linear(
        u, prob.p0, prob.v0, dt, mass, gravity_vec
    )
    w = weights
    hover = _hover(u, mass, gravity_vec)
    goal = _goal_steps(prob)
    pe = pos - goal
    J = w.position * (pe * pe).sum((-1, -2))
    J = J + w.velocity * (vel * vel).sum((-1, -2))
    J = J + w.acceleration * (acc * acc).sum((-1, -2))
    du = u - hover
    J = J + w.thrust * (du * du).sum((-1, -2))
    term = pos[..., -1, :] - goal[..., -1, :]
    J = J + w.terminal * w.position * (term * term).sum(-1)
    J = J + w.obstacle * obstacle_penalty(pos, prob.obstacles, prob.obstacle_mask)
    if w.ground > 0.0:
        gviol = torch.clamp(w.ground_altitude - pos[..., 2], min=0.0)
        J = J + w.ground * (gviol * gviol).sum(-1)
    if w.velocity_bound > 0.0:
        vviol = torch.clamp(vel.abs() - effective_vmax(prob, w), min=0.0)
        J = J + w.velocity_bound * (vviol * vviol).sum((-1, -2))
    if w.tilt > 0.0:
        lat = torch.sqrt((u[..., :2] * u[..., :2]).sum(-1) + 1e-9)
        tviol = torch.clamp(lat - w.tan_max_tilt * u[..., 2], min=0.0)
        J = J + w.tilt * (tviol * tviol).sum(-1)
    if w.thrust_norm > 0.0:
        un = torch.sqrt((u * u).sum(-1) + 1e-9)
        nviol = torch.clamp(un - w.max_thrust_norm, min=0.0)
        J = J + w.thrust_norm * (nviol * nviol).sum(-1)
    return J


def _transposed_maps_on(N: int, dt: float, *, dtype, device) -> tuple[Tensor, Tensor]:
    """(S_p^T, S_v^T) of :func:`~.dynamics.rollout_matrices` on ``device``."""
    S_p, S_v, _ = dynamics.rollout_matrices(N, dt)
    return (torch.as_tensor(S_p.T, dtype=dtype, device=device),
            torch.as_tensor(S_v.T, dtype=dtype, device=device))


def condensed_grad(
    u: Tensor,
    prob: Problem,
    weights: CostWeights,
    dt: float,
    mass: float,
    gravity_vec: Tensor,
) -> Tensor:
    """Analytic gradient dJ/du (..., N, 3).

    Physical-space gradients (dJ/dp, dJ/dv) are pulled back through the
    rollout maps: ``dJ/du = (S_p^T dJ/dp + S_v^T dJ/dv) / m`` plus the
    thrust-space terms (smoothness, effort, tilt-cone, thrust-norm).
    """
    w = weights
    N = u.shape[-2]
    pos, vel, acc = dynamics.rollout_linear(
        u, prob.p0, prob.v0, dt, mass, gravity_vec
    )
    hover = _hover(u, mass, gravity_vec)
    pe = pos - _goal_steps(prob)
    wp = torch.full((N, 1), w.position, dtype=u.dtype, device=u.device)
    wp[-1] = w.position * (1.0 + w.terminal)
    gpos = 2.0 * wp * pe

    diff, d, r_safe = _obstacle_geometry(pos, prob.obstacles)
    mask = prob.obstacle_mask[..., None, :].to(u.dtype)
    viol = torch.clamp(r_safe - d, min=0.0) * mask  # (..., N, K)
    coef = (2.0 * w.obstacle) * viol / d
    gpos = gpos - (coef[..., None] * diff).sum(-2)
    if w.ground > 0.0:
        gviol = torch.clamp(w.ground_altitude - pos[..., 2], min=0.0)
        gz = torch.zeros_like(gpos)
        gz[..., 2] = -2.0 * w.ground * gviol
        gpos = gpos + gz
    gvel = 2.0 * w.velocity * vel
    if w.velocity_bound > 0.0:
        vviol = torch.clamp(vel.abs() - effective_vmax(prob, w), min=0.0)
        gvel = gvel + (2.0 * w.velocity_bound) * torch.sign(vel) * vviol

    S_pT, S_vT = device_constant(_transposed_maps_on, N, float(dt), dtype=u.dtype,
                                 device=u.device)
    ga = dynamics.apply_steps(S_pT, gpos) + dynamics.apply_steps(S_vT, gvel)
    ga = ga + 2.0 * w.acceleration * acc
    grad = ga / mass + 2.0 * w.thrust * (u - hover)

    if w.tilt > 0.0:
        lat = torch.sqrt((u[..., :2] * u[..., :2]).sum(-1) + 1e-9)
        tv = torch.clamp(lat - w.tan_max_tilt * u[..., 2], min=0.0)
        c = (2.0 * w.tilt) * tv
        jac = torch.stack(
            [u[..., 0] / lat, u[..., 1] / lat,
             torch.full_like(lat, -w.tan_max_tilt)],
            dim=-1,
        )
        grad = grad + c[..., None] * jac
    if w.thrust_norm > 0.0:
        un = torch.sqrt((u * u).sum(-1) + 1e-9)
        nv = torch.clamp(un - w.max_thrust_norm, min=0.0)
        grad = grad + ((2.0 * w.thrust_norm) * nv / un)[..., None] * u
    return grad


@functools.lru_cache(maxsize=32)
def quadratic_hessian(
    N: int,
    dt: float,
    mass: float,
    gravity_z: float,
    weights: CostWeights,
) -> np.ndarray:
    """Constant per-axis Hessian (N, N) of the quadratic cost terms wrt u
    (float64 numpy, cached per configuration)."""
    S_p, S_v, _ = dynamics.rollout_matrices(N, dt)
    w = weights
    Hp = S_p.T @ S_p + w.terminal * np.outer(S_p[-1], S_p[-1])
    Hv = S_v.T @ S_v
    H = 2.0 * (
        w.position * Hp / (mass * mass)
        + w.velocity * Hv / (mass * mass)
        + (w.acceleration / (mass * mass) + w.thrust) * np.eye(N)
    )
    return H



def obstacle_gn_hessian(
    u: Tensor,
    prob: Problem,
    weights: CostWeights,
    dt: float,
    mass: float,
    gravity_vec: Tensor,
    include_obstacles: bool = True,
) -> Tensor:
    """Dense Gauss-Newton Hessian of the hinge penalties (obstacles,
    ground, velocity envelope) pulled back to thrust space: (..., N, 3, N, 3).

    Per step, the obstacle hinges give H_p[k] = 2 w_obs sum_o n n^T over the
    active spheres (n the unit normal), the ground hinge 2 w_g e_z e_z^T on
    active steps; H_u[(i,a),(j,b)] = sum_k S_p[k,i] S_p[k,j] H_p[k,a,b] / m^2.
    The velocity hinge adds 2 w_vb per active axis through S_v. The solver
    never forms this matrix (it applies the blocks of
    :func:`penalty_blocks`); it is the dense check of those blocks."""
    pos, vel, _ = dynamics.rollout_linear(u, prob.p0, prob.v0, dt, mass, gravity_vec)
    N = u.shape[-2]
    kw = dict(dtype=u.dtype, device=u.device)
    Hp = torch.zeros(u.shape[:-2] + (N, 3, 3), **kw)
    if include_obstacles:
        diff, d, r_safe = _obstacle_geometry(pos, prob.obstacles)
        active = ((r_safe > d) & prob.obstacle_mask[..., None, :]).to(u.dtype)
        n = diff / d[..., None]
        Hp = Hp + 2.0 * weights.obstacle * torch.einsum(
            "...nka,...nkb,...nk->...nab", n, n, active
        )
    if weights.ground > 0.0:
        g_active = (pos[..., 2] < weights.ground_altitude).to(u.dtype)
        e_zz = torch.zeros((3, 3), **kw)
        e_zz[2, 2] = 1.0
        Hp = Hp + 2.0 * weights.ground * g_active[..., None, None] * e_zz
    S_p, S_v = dynamics.scaled_maps(N, dt, mass, u.dtype, u.device)
    H_u = torch.einsum("ki,kj,...kab->...iajb", S_p, S_p, Hp)
    if weights.velocity_bound > 0.0:
        v_active = (vel.abs() > effective_vmax(prob, weights)).to(u.dtype)
        # per-axis blocks: the axes never couple, so spread with delta_ab
        tmp = torch.einsum(
            "ki,kj,...ka->...iaj", S_v, S_v, 2.0 * weights.velocity_bound * v_active
        )
        H_u = H_u + tmp[..., None] * torch.eye(3, **kw)[None, :, None, :]
    return H_u


def _outer(a: Tensor, b: Tensor) -> Tensor:
    return a[..., :, None] * b[..., None, :]


def penalty_blocks(
    u: Tensor,
    prob: Problem,
    weights: CostWeights,
    dt: float,
    mass: float,
    gravity_vec: Tensor,
    include_obstacles: bool = True,
    full_curvature: bool = False,
) -> tuple[Tensor, Tensor, Optional[Tensor]]:
    """Per-step Hessian blocks of the hinge penalties.

    Returns ``(Hp, Hv_diag, Hu)``: ``Hp`` (..., N, 3, 3) position-space
    blocks (obstacles + ground), ``Hv_diag`` (..., N, 3) velocity-space
    diagonal (velocity-envelope hinge), ``Hu`` (..., N, 3, 3) thrust-space
    blocks (tilt-cone + thrust-norm) or ``None`` when both are off.

    ``full_curvature=False`` gives Gauss-Newton blocks; ``True`` adds the
    ``h * hess(h)`` terms: for the sphere hinge the negative tangential
    curvature ``-2 w (h/d)(I - n n^T)``, for the convex norm hinges their
    positive curvature.
    """
    pos, vel, _ = dynamics.rollout_linear(
        u, prob.p0, prob.v0, dt, mass, gravity_vec
    )
    N_h = u.shape[-2]
    kw = dict(dtype=u.dtype, device=u.device)
    Hp = torch.zeros(u.shape[:-2] + (N_h, 3, 3), **kw)
    eye3 = torch.eye(3, **kw)
    if include_obstacles:
        diff, d, r_safe = _obstacle_geometry(pos, prob.obstacles)
        active = (
            (r_safe > d) & prob.obstacle_mask[..., None, :]
        ).to(u.dtype)
        n = diff / d[..., None]
        nn = _outer(n, n)  # (..., N, K, 3, 3)
        if full_curvature:
            hd = torch.clamp(r_safe - d, min=0.0) / d
            Hp = Hp + 2.0 * weights.obstacle * (
                nn * (active * (1.0 + hd))[..., None, None]
            ).sum(-3)
            Hp = Hp - (
                2.0 * weights.obstacle * (active * hd).sum(-1)
            )[..., None, None] * eye3
        else:
            Hp = Hp + 2.0 * weights.obstacle * (
                nn * active[..., None, None]
            ).sum(-3)
    if weights.ground > 0.0:
        g_active = (pos[..., 2] < weights.ground_altitude).to(u.dtype)
        Hp[..., 2, 2] += 2.0 * weights.ground * g_active
    Hv_diag = torch.zeros(u.shape[:-2] + (N_h, 3), **kw)
    if weights.velocity_bound > 0.0:
        v_active = (vel.abs() > effective_vmax(prob, weights)).to(u.dtype)
        Hv_diag = (2.0 * weights.velocity_bound * v_active).expand_as(Hv_diag)
    Hu = None
    if weights.tilt > 0.0 or weights.thrust_norm > 0.0:
        Hu = torch.zeros(u.shape[:-2] + (N_h, 3, 3), **kw)
    if weights.tilt > 0.0:
        lat = torch.sqrt((u[..., :2] * u[..., :2]).sum(-1) + 1e-9)
        tv = torch.clamp(lat - weights.tan_max_tilt * u[..., 2], min=0.0)
        t_active = (tv > 0.0).to(u.dtype)
        jv = torch.cat(
            [u[..., :2] / lat[..., None],
             torch.full(u.shape[:-1] + (1,), -weights.tan_max_tilt, **kw)],
            dim=-1,
        )
        Hu = Hu + 2.0 * weights.tilt * t_active[..., None, None] * _outer(jv, jv)
        if full_curvature:
            q = u[..., :2] / lat[..., None]
            hxy = (torch.eye(2, **kw) - _outer(q, q)) / lat[..., None, None]
            Hu[..., :2, :2] += 2.0 * weights.tilt * tv[..., None, None] * hxy
    if weights.thrust_norm > 0.0:
        un = torch.sqrt((u * u).sum(-1) + 1e-9)
        nvh = torch.clamp(un - weights.max_thrust_norm, min=0.0)
        n_active = (nvh > 0.0).to(u.dtype)
        nv = u / un[..., None]
        Hu = Hu + 2.0 * weights.thrust_norm * n_active[..., None, None] * _outer(nv, nv)
        if full_curvature:
            hn = (eye3 - _outer(nv, nv)) / un[..., None, None]
            Hu = Hu + 2.0 * weights.thrust_norm * nvh[..., None, None] * hn
    return Hp, Hv_diag, Hu
