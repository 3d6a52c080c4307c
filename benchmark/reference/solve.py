"""Plain PyTorch reference of the batched SE(3) MPC solve: a frozen copy of
the port's plain path (``planning/se3_mpc.py``'s Newton loop, tail pass,
cold start, warm start and trajectory extraction, ``ops/costs.py`` and
``ops/dynamics.py``), written against its own configuration tuple. It
imports nothing of the program, of JAX or of the JAX package.

Every product of a horizon map or of two rotations goes through
:func:`matmul`: exact fp32 while TF32 is off, as the configurations
require. The benchmark's control swaps it for a product of TF32-rounded
operands.

The solver: a condensed projected-Newton QP over thrust vectors (3N
variables; the dynamics eliminated through the affine rollout), box bounds
by an active-set mask and a projected line search, hinge penalties
(obstacles, ground, velocity envelope, tilt cone, thrust norm) with
Gauss-Newton then full-curvature blocks, a fixed budget with per-scenario
convergence; then a compacted tail pass over the worst scenarios.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

Tensor = torch.Tensor


class SolverConfig(NamedTuple):
    """The solve's configuration: the port's ``SE3MPCConfig`` fields."""

    prediction_horizon: int = 20
    dt: float = 0.1
    max_velocity: float = 10.0
    max_acceleration: float = 15.0
    max_thrust: float = 25.0
    min_thrust: float = 2.0
    max_tilt_angle: float = float(np.pi / 4)
    position_weight: float = 100.0
    velocity_weight: float = 10.0
    acceleration_weight: float = 1.0
    thrust_weight: float = 0.1
    terminal_weight: float = 10.0
    obstacle_weight: float = 1000.0
    safety_margin: float = 1.5
    max_iterations: int = 12
    convergence_tolerance: float = 5e-2
    ftol: float = 1e-6
    cg_iterations: int = 10
    line_search_alphas: tuple = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01)
    newton_full_curvature: bool = True
    gn_warmup_iterations: int = 6
    tail_iterations: int = 8
    tail_cg_iterations: int = 25
    tail_capacity: float = 0.25
    tail_line_search_alphas: tuple = (1.0, 0.5, 0.25, 0.05)
    restart_iterations: int = 0
    restart_capacity: float = 0.25
    restart_noise: float = 2.0
    cold_start: str = "qp"
    goal_margin_clamp: float = 0.0
    goal_margin_floor: float = 0.6
    ground_weight: float = 50000.0
    min_altitude: float = 0.3
    velocity_bound_weight: float = 1000.0
    tilt_weight: float = 10.0
    thrust_norm_weight: float = 10.0
    mass: float = 1.5
    gravity: float = 9.81
    max_obstacles: int = 8

    @classmethod
    def from_dict(cls, d: dict) -> "SolverConfig":
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})


class Problem(NamedTuple):
    p0: Tensor  # (B, 3)
    v0: Tensor  # (B, 3)
    goal: Tensor  # (B, 3)
    obstacles: Tensor  # (B, K, 4) centre and radius with the margin added
    obstacle_mask: Tensor  # (B, K)
    v_cap: Optional[Tensor] = None  # (B,)


class Result(NamedTuple):
    thrusts: Tensor
    positions: Tensor
    velocities: Tensor
    accelerations: Tensor
    cost: Tensor
    converged: Tensor


def matmul(a: Tensor, b: Tensor) -> Tensor:
    """Every matrix product of the references (looked up at each call)."""
    return torch.matmul(a, b)


def tf32(x: Tensor) -> Tensor:
    """``x`` (float32) rounded to TF32's 10-bit mantissa, to nearest even:
    what a TF32 tensor core reads of an fp32 operand."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x0FFF + ((b >> 13) & 1)) & -8192).view(torch.float32)


def tf32_matmul(a: Tensor, b: Tensor) -> Tensor:
    """A product computed in TF32: operands rounded to TF32, products summed
    in fp32."""
    return torch.matmul(tf32(a), tf32(b))


def tan_max_tilt(c: SolverConfig) -> float:
    return float(np.tan(c.max_tilt_angle))


def bounds(c: SolverConfig, dtype, device) -> tuple[Tensor, Tensor]:
    mtt = c.max_thrust * float(np.sin(c.max_tilt_angle))
    kw = dict(dtype=dtype, device=device)
    return (torch.tensor([-mtt, -mtt, c.min_thrust], **kw),
            torch.tensor([mtt, mtt, c.max_thrust], **kw))


def gravity(c: SolverConfig, dtype, device) -> Tensor:
    return torch.tensor([0.0, 0.0, -c.gravity], dtype=dtype, device=device)


def rollout_matrices(N: int, dt: float):
    k = np.arange(N)[:, None]
    j = np.arange(N)[None, :]
    mask = (j < k).astype(np.float64)
    return (dt * dt) * (k - j - 0.5) * mask, dt * mask, dt * np.arange(N, dtype=np.float64)


def rollout(c: SolverConfig, u: Tensor, p0: Tensor, v0: Tensor):
    """Thrusts (B, N, 3) -> positions, velocities, accelerations."""
    Sp, Sv, t = rollout_matrices(u.shape[-2], float(c.dt))
    kw = dict(dtype=u.dtype, device=u.device)
    a = u / c.mass + gravity(c, u.dtype, u.device)
    vel = v0[..., None, :] + matmul(torch.as_tensor(Sv, **kw), a)
    pos = (p0[..., None, :] + torch.as_tensor(t, **kw)[:, None] * v0[..., None, :]
           + matmul(torch.as_tensor(Sp, **kw), a))
    return pos, vel, a


def _vmax(c: SolverConfig, prob: Problem):
    return c.max_velocity if prob.v_cap is None else prob.v_cap[..., None, None]


def _geometry(pos: Tensor, obstacles: Tensor):
    diff = pos[..., :, None, :] - obstacles[..., None, :, :3]
    d = torch.sqrt((diff * diff).sum(-1) + 1e-9)
    return diff, d, obstacles[..., 3][..., None, :]


def cost(c: SolverConfig, prob: Problem, u: Tensor) -> Tensor:
    pos, vel, acc = rollout(c, u, prob.p0, prob.v0)
    hover = torch.tensor([0.0, 0.0, c.mass * c.gravity], dtype=u.dtype, device=u.device)
    pe = pos - prob.goal[..., None, :]
    J = c.position_weight * (pe * pe).sum((-1, -2))
    J = J + c.velocity_weight * (vel * vel).sum((-1, -2))
    J = J + c.acceleration_weight * (acc * acc).sum((-1, -2))
    du = u - hover
    J = J + c.thrust_weight * (du * du).sum((-1, -2))
    term = pe[..., -1, :]
    J = J + c.terminal_weight * c.position_weight * (term * term).sum(-1)
    _, d, r = _geometry(pos, prob.obstacles)
    viol = torch.clamp(r - d, min=0.0) * prob.obstacle_mask[..., None, :].to(u.dtype)
    J = J + c.obstacle_weight * (viol * viol).sum((-1, -2))
    g = torch.clamp(c.min_altitude - pos[..., 2], min=0.0)
    J = J + c.ground_weight * (g * g).sum(-1)
    vv = torch.clamp(vel.abs() - _vmax(c, prob), min=0.0)
    J = J + c.velocity_bound_weight * (vv * vv).sum((-1, -2))
    lat = torch.sqrt((u[..., :2] * u[..., :2]).sum(-1) + 1e-9)
    tv = torch.clamp(lat - tan_max_tilt(c) * u[..., 2], min=0.0)
    J = J + c.tilt_weight * (tv * tv).sum(-1)
    un = torch.sqrt((u * u).sum(-1) + 1e-9)
    nv = torch.clamp(un - c.max_thrust, min=0.0)
    return J + c.thrust_norm_weight * (nv * nv).sum(-1)


def grad(c: SolverConfig, prob: Problem, u: Tensor) -> Tensor:
    N = u.shape[-2]
    kw = dict(dtype=u.dtype, device=u.device)
    pos, vel, acc = rollout(c, u, prob.p0, prob.v0)
    hover = torch.tensor([0.0, 0.0, c.mass * c.gravity], **kw)
    pe = pos - prob.goal[..., None, :]
    wp = torch.full((N, 1), c.position_weight, **kw)
    wp[-1] = c.position_weight * (1.0 + c.terminal_weight)
    gpos = 2.0 * wp * pe
    diff, d, r = _geometry(pos, prob.obstacles)
    viol = torch.clamp(r - d, min=0.0) * prob.obstacle_mask[..., None, :].to(u.dtype)
    coef = (2.0 * c.obstacle_weight) * viol / d
    gpos = gpos - (coef[..., None] * diff).sum(-2)
    gviol = torch.clamp(c.min_altitude - pos[..., 2], min=0.0)
    gz = torch.zeros_like(gpos)
    gz[..., 2] = -2.0 * c.ground_weight * gviol
    gpos = gpos + gz
    gvel = 2.0 * c.velocity_weight * vel
    vv = torch.clamp(vel.abs() - _vmax(c, prob), min=0.0)
    gvel = gvel + (2.0 * c.velocity_bound_weight) * torch.sign(vel) * vv
    Sp, Sv, _ = rollout_matrices(N, float(c.dt))
    ga = (matmul(torch.as_tensor(Sp.T, **kw), gpos)
          + matmul(torch.as_tensor(Sv.T, **kw), gvel))
    ga = ga + 2.0 * c.acceleration_weight * acc
    g = ga / c.mass + 2.0 * c.thrust_weight * (u - hover)
    tm = tan_max_tilt(c)
    lat = torch.sqrt((u[..., :2] * u[..., :2]).sum(-1) + 1e-9)
    tv = torch.clamp(lat - tm * u[..., 2], min=0.0)
    jac = torch.stack([u[..., 0] / lat, u[..., 1] / lat, torch.full_like(lat, -tm)], -1)
    g = g + ((2.0 * c.tilt_weight) * tv)[..., None] * jac
    un = torch.sqrt((u * u).sum(-1) + 1e-9)
    nv = torch.clamp(un - c.max_thrust, min=0.0)
    return g + ((2.0 * c.thrust_norm_weight) * nv / un)[..., None] * u


def quadratic_hessian(c: SolverConfig) -> np.ndarray:
    """The constant per-axis Hessian (N, N) of the quadratic terms, float64."""
    N = c.prediction_horizon
    Sp, Sv, _ = rollout_matrices(N, float(c.dt))
    m2 = c.mass * c.mass
    Hp = Sp.T @ Sp + c.terminal_weight * np.outer(Sp[-1], Sp[-1])
    return 2.0 * (c.position_weight * Hp / m2 + c.velocity_weight * (Sv.T @ Sv) / m2
                  + (c.acceleration_weight / m2 + c.thrust_weight) * np.eye(N))


def _outer(a: Tensor, b: Tensor) -> Tensor:
    return a[..., :, None] * b[..., None, :]


def penalty_blocks(c: SolverConfig, prob: Problem, u: Tensor, use_obstacles: bool,
                   full: bool):
    """Per-step Hessian blocks of the hinges: position-space (B, N, 3, 3),
    velocity-space diagonal (B, N, 3), thrust-space (B, N, 3, 3)."""
    pos, vel, _ = rollout(c, u, prob.p0, prob.v0)
    N = u.shape[-2]
    kw = dict(dtype=u.dtype, device=u.device)
    Hp = torch.zeros(u.shape[:-2] + (N, 3, 3), **kw)
    eye3 = torch.eye(3, **kw)
    w = c.obstacle_weight
    if use_obstacles:
        diff, d, r = _geometry(pos, prob.obstacles)
        active = ((r > d) & prob.obstacle_mask[..., None, :]).to(u.dtype)
        n = diff / d[..., None]
        nn = _outer(n, n)
        if full:
            hd = torch.clamp(r - d, min=0.0) / d
            Hp = Hp + 2.0 * w * (nn * (active * (1.0 + hd))[..., None, None]).sum(-3)
            Hp = Hp - (2.0 * w * (active * hd).sum(-1))[..., None, None] * eye3
        else:
            Hp = Hp + 2.0 * w * (nn * active[..., None, None]).sum(-3)
    g_active = (pos[..., 2] < c.min_altitude).to(u.dtype)
    Hp[..., 2, 2] += 2.0 * c.ground_weight * g_active
    v_active = (vel.abs() > _vmax(c, prob)).to(u.dtype)
    Hv = 2.0 * c.velocity_bound_weight * v_active
    tm = tan_max_tilt(c)
    lat = torch.sqrt((u[..., :2] * u[..., :2]).sum(-1) + 1e-9)
    tv = torch.clamp(lat - tm * u[..., 2], min=0.0)
    jv = torch.cat([u[..., :2] / lat[..., None],
                    torch.full(u.shape[:-1] + (1,), -tm, **kw)], dim=-1)
    Hu = 2.0 * c.tilt_weight * (tv > 0.0).to(u.dtype)[..., None, None] * _outer(jv, jv)
    if full:
        q = u[..., :2] / lat[..., None]
        hxy = (torch.eye(2, **kw) - _outer(q, q)) / lat[..., None, None]
        Hu[..., :2, :2] += 2.0 * c.tilt_weight * tv[..., None, None] * hxy
    un = torch.sqrt((u * u).sum(-1) + 1e-9)
    nvh = torch.clamp(un - c.max_thrust, min=0.0)
    nvec = u / un[..., None]
    Hu = Hu + 2.0 * c.thrust_norm_weight * (nvh > 0.0).to(u.dtype)[..., None, None] * _outer(
        nvec, nvec)
    if full:
        Hu = Hu + 2.0 * c.thrust_norm_weight * nvh[..., None, None] * (
            (eye3 - _outer(nvec, nvec)) / un[..., None, None])
    return Hp, Hv, Hu


def _sum(x: Tensor) -> Tensor:
    return x.sum((-1, -2), keepdim=True)


def stages(c: SolverConfig) -> tuple[int, int]:
    if not c.newton_full_curvature:
        return c.max_iterations, 0
    warm = min(c.gn_warmup_iterations, c.max_iterations)
    return warm, c.max_iterations - warm


def newton(c: SolverConfig, prob: Problem, u: Tensor, use_obstacles: bool = True):
    """The fixed-budget projected-Newton loop: the final thrusts and the
    least realized relative improvement of the final stage."""
    N = c.prediction_horizon
    kw = dict(dtype=u.dtype, device=u.device)
    lb, ub = bounds(c, u.dtype, u.device)
    H = torch.as_tensor(quadratic_hessian(c), **kw)
    dq = torch.diagonal(H)[:, None].expand(N, 3)
    Sp_np, Sv_np, _ = rollout_matrices(N, float(c.dt))
    Sp = torch.as_tensor(Sp_np, **kw) / c.mass
    Sv = torch.as_tensor(Sv_np, **kw) / c.mass
    SpT, SvT = Sp.T.contiguous(), Sv.T.contiguous()
    Sp2T, Sv2T = (Sp * Sp).T.contiguous(), (Sv * Sv).T.contiguous()
    alphas = torch.tensor(c.line_search_alphas, **kw).reshape((-1,) + (1,) * u.ndim)

    def round_(u, min_imp, full):
        g = grad(c, prob, u)
        at_lo = (u <= lb + 1e-6) & (g > 0)
        at_hi = (u >= ub - 1e-6) & (g < 0)
        free = (~(at_lo | at_hi)).to(u.dtype)
        Hp, Hv, Hu = penalty_blocks(c, prob, u, use_obstacles, full)

        def matvec(dv):
            dv = dv * free
            out = matmul(H, dv)
            z = (Hp * matmul(Sp, dv)[..., None, :]).sum(-1)
            out = out + matmul(SpT, z)
            out = out + matmul(SvT, Hv * matmul(Sv, dv))
            out = out + (Hu * dv[..., None, :]).sum(-1)
            return out * free

        diag = (dq + matmul(Sp2T, torch.diagonal(Hp, dim1=-2, dim2=-1))
                + matmul(Sv2T, Hv) + torch.diagonal(Hu, dim1=-2, dim2=-1))
        if full:
            minv = free / torch.maximum(diag, 0.1 * dq)
        else:
            minv = free / torch.clamp(diag, min=1e-8)
        r = -(g * free)
        z0 = minv * r
        rz = _sum(r * z0)
        d = torch.zeros_like(r)
        p = z0
        alive = torch.ones(rz.shape, dtype=torch.bool, device=u.device)
        for _ in range(c.cg_iterations):
            ap = matvec(p)
            pap = _sum(p * ap)
            alive = alive & (pap > 1e-8 * _sum(p * p))
            ok = alive.to(u.dtype)
            a = ok * rz / torch.clamp(pap, min=1e-12)
            d = d + a * p
            r = r - a * ap
            z = minv * r
            rz_new = _sum(r * z)
            beta = ok * rz_new / torch.clamp(rz, min=1e-12)
            p = z * ok + beta * p + (1.0 - ok) * p
            rz = torch.where(alive, rz_new, rz)
        if full:
            d = torch.where(_sum(d.abs()) > 0.0, d, z0)
        d = d * free
        cand = torch.clamp(u[None] + alphas * d[None], lb, ub)
        cur = cost(c, prob, u)
        best_cost, best = torch.min(torch.cat([cost(c, prob, cand), cur[None]], 0), 0)
        allc = torch.cat([cand, u[None]], 0)
        u_next = torch.gather(allc, 0, best[None, ..., None, None].expand((1,) + u.shape))[0]
        imp = (cur - best_cost) / (1.0 + best_cost.abs())
        return u_next, torch.minimum(min_imp, imp)

    inf = torch.full(u.shape[:-2], math.inf, **kw)
    n_gn, n_full = stages(c)
    min_imp = inf
    for _ in range(n_gn):
        u, min_imp = round_(u, min_imp, False)
    if n_full > 0:
        min_imp = inf
        for _ in range(n_full):
            u, min_imp = round_(u, min_imp, True)
    return u, min_imp


def finalize(c: SolverConfig, prob: Problem, u: Tensor, min_imp: Tensor) -> Result:
    pos, vel, acc = rollout(c, u, prob.p0, prob.v0)
    return Result(u, pos, vel, acc, cost(c, prob, u), min_imp <= c.ftol)


def cold_start(c: SolverConfig, prob: Problem) -> Tensor:
    """The box-clipped minimizer of the quadratic terms from hover."""
    N = c.prediction_horizon
    dtype, device = prob.p0.dtype, prob.p0.device
    hover = torch.tensor([0.0, 0.0, c.mass * c.gravity], dtype=dtype, device=device)
    uh = hover.expand(prob.p0.shape[:-1] + (N, 3))
    quad = c._replace(obstacle_weight=0.0, ground_weight=0.0, velocity_bound_weight=0.0,
                      tilt_weight=0.0, thrust_norm_weight=0.0)
    g = grad(quad, prob, uh)
    Hinv = torch.as_tensor(np.linalg.inv(quadratic_hessian(c)), dtype=dtype, device=device)
    lb, ub = bounds(c, dtype, device)
    return torch.clamp(uh - matmul(Hinv, g), lb, ub)


def shift(u: Tensor) -> Tensor:
    """The warm start: the last plan shifted one step, its last thrust
    repeated."""
    return torch.cat([u[..., 1:, :], u[..., -1:, :]], dim=-2)


def tail_config(c: SolverConfig) -> SolverConfig:
    return c._replace(max_iterations=c.tail_iterations, cg_iterations=c.tail_cg_iterations,
                      newton_full_curvature=True, gn_warmup_iterations=0, tail_iterations=0,
                      restart_iterations=0, line_search_alphas=c.tail_line_search_alphas)


def solve(c: SolverConfig, prob: Problem, u_init: Optional[Tensor] = None) -> Result:
    """Phase 1 from ``u_init`` (the cold start if None), then, with
    ``tail_iterations`` > 0, the first ``ceil(tail_capacity * B)``
    scenarios ranked unconverged-first (a stable partition) re-solved from
    their phase-1 thrusts at the tail's budget, merged where no worse."""
    if c.restart_iterations > 0:
        raise ValueError("the reference has no perturbed restart")
    if u_init is None:
        u_init = cold_start(c, prob)
    u, imp = newton(c, prob, u_init)
    res = finalize(c, prob, u, imp)
    if c.tail_iterations <= 0:
        return res
    B = res.cost.shape[0]
    C = max(1, int(math.ceil(c.tail_capacity * B)))
    unconv = ~res.converged
    order = torch.cat([torch.nonzero(unconv)[:, 0], torch.nonzero(~unconv)[:, 0]])
    idx = order[:C]
    sub = Problem(*[None if x is None else x[idx] for x in prob])
    u_t, imp_t = newton(tail_config(c), sub, res.thrusts[idx])
    ref = finalize(c, sub, u_t, imp_t)
    use = ref.cost <= res.cost[idx]

    def merge(old, new):
        out = old.clone()
        sel = use.reshape(use.shape + (1,) * (new.ndim - 1))
        out[idx] = torch.where(sel, new, old[idx])
        return out

    conv = res.converged.clone()
    conv[idx] = res.converged[idx] | (use & ref.converged)
    return Result(merge(res.thrusts, ref.thrusts), merge(res.positions, ref.positions),
                  merge(res.velocities, ref.velocities),
                  merge(res.accelerations, ref.accelerations), merge(res.cost, ref.cost), conv)


def margins(c: SolverConfig, obstacles: Tensor, goal: Tensor) -> Tensor:
    """The safety margin each sphere's radius gains: the configured margin,
    shrunk by the goal-margin clamp where the inflated ball would come
    within ``goal_margin_clamp`` of the goal, floored at
    ``goal_margin_floor``."""
    if c.goal_margin_clamp <= 0.0:
        return torch.full(obstacles.shape[:-1], c.safety_margin, dtype=obstacles.dtype,
                          device=obstacles.device)
    gd = torch.linalg.vector_norm(goal[..., None, :] - obstacles[..., :3], dim=-1)
    room = gd - obstacles[..., 3] - c.goal_margin_clamp
    return torch.clamp(torch.clamp(room, max=c.safety_margin), c.goal_margin_floor,
                       c.safety_margin)


def make_problem(c: SolverConfig, p0: Tensor, v0: Tensor, goal: Tensor,
                 spheres: Tensor) -> Problem:
    """A problem over live spheres (B, L, 4): margins added, padded to
    ``max_obstacles`` with inactive slots."""
    B, L = spheres.shape[0], spheres.shape[1]
    obs = spheres.clone()
    obs[..., 3] += margins(c, spheres, goal)
    pad = c.max_obstacles - L
    obs = torch.cat([obs, torch.zeros((B, pad, 4), dtype=obs.dtype, device=obs.device)], 1)
    mask = torch.zeros((B, c.max_obstacles), dtype=torch.bool, device=obs.device)
    mask[:, :L] = True
    return Problem(p0, v0, goal, obs, mask)


def extract(c: SolverConfig, u: Tensor, start_time: Tensor):
    """Attitudes (the thrust frame at yaw 0 as ZYX Euler angles), body
    rates (finite differences of the frames, ``vee(R_k^T dR_k)``), thrust
    magnitudes and timestamps of thrust plans (B, N, 3)."""
    N = c.prediction_horizon
    tmag = torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    ok = tmag > 1e-6
    e = torch.eye(3, dtype=u.dtype, device=u.device)
    b3 = torch.where(ok, u / torch.where(ok, tmag, torch.ones_like(tmag)), e[2])
    cvec = e[0].expand(b3.shape)
    b1r = torch.linalg.cross(cvec, b3, dim=-1)
    b1n = torch.linalg.vector_norm(b1r, dim=-1, keepdim=True)
    axis = torch.where(b3[..., 0:1].abs() > 0.9, e[1], e[0])
    proj = axis - (axis * b3).sum(-1, keepdim=True) * b3
    pn = torch.linalg.vector_norm(proj, dim=-1, keepdim=True)
    fb = torch.where(pn > 1e-6, proj / torch.where(pn > 1e-6, pn, torch.ones_like(pn)), e[0])
    b1 = torch.where(b1n > 1e-6, b1r / torch.where(b1n > 1e-6, b1n, torch.ones_like(b1n)), fb)
    R = torch.stack([b1, torch.linalg.cross(b3, b1, dim=-1), b3], dim=-1)
    R = torch.where(ok[..., None], R, e)
    att = torch.stack([torch.atan2(R[..., 2, 1], R[..., 2, 2]),
                       torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0)),
                       torch.atan2(R[..., 1, 0], R[..., 0, 0])], dim=-1)
    R_prev = torch.cat([R[..., :1, :, :], R[..., :-1, :, :]], dim=-3)
    W = matmul(R.transpose(-1, -2), (R - R_prev) / c.dt)
    rates = torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)
    rates[..., 0, :] = 0.0
    att = torch.where(ok, att, 0.0)
    rates = torch.where(ok, rates, 0.0)
    ts = start_time[..., None] + c.dt * torch.arange(N, dtype=u.dtype, device=u.device)
    return att, rates, tmag[..., 0], ts
