"""SE(3) model-predictive trajectory optimizer (PyTorch counterpart of
:mod:`dart_planner_tpu.planning.se3_mpc`).

The solver is a condensed projected-Newton QP over thrust vectors only
(3N variables; the dynamics are eliminated through the affine rollout of
:mod:`..ops.dynamics`): box bounds by an active-set mask and a projected
line search, hinge penalties (obstacles, ground, velocity envelope, tilt
cone, thrust norm) with Gauss-Newton then full-curvature blocks, and a
fixed iteration budget with per-scenario convergence masks, so one code
path serves a single solve and a 100k-scenario batch.

:func:`solve` picks the solver path by device: ``method="auto"`` runs the
hand-written CUDA kernel (:mod:`..ops.cuda_mpc`) when the problem's tensors
are on a GPU, and the plain PyTorch Newton loop (:func:`solve_se3_mpc`)
when they are on the CPU. ``"torch"`` forces the plain loop on any device;
``"cuda"`` on CPU tensors raises.
"""

from __future__ import annotations

import functools
import math
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from dart_planner_tpu_torch.common import frames
from dart_planner_tpu_torch.common.device import default_device, resolve_device
from dart_planner_tpu_torch.common.types import DroneState, Trajectory
from dart_planner_tpu_torch.ops import costs, cuda_mpc, dynamics, so3
from dart_planner_tpu_torch.planning.base import BasePlanner

Tensor = torch.Tensor

METHODS = ("auto", "torch", "cuda")


class SE3MPCConfig(NamedTuple):
    """Static solver configuration: the same fields and defaults as the
    JAX package's ``SE3MPCConfig`` (see its docstring for the measured
    rationale of each default), so ``SE3MPCConfig(**jax_cfg._asdict())``
    carries a configuration across."""

    prediction_horizon: int = 20
    dt: float = 0.1

    max_velocity: float = 10.0  # m/s
    max_acceleration: float = 15.0  # m/s^2
    max_thrust: float = 25.0  # N
    min_thrust: float = 2.0  # N
    max_tilt_angle: float = float(np.pi / 4)  # rad

    position_weight: float = 100.0
    velocity_weight: float = 10.0
    acceleration_weight: float = 1.0
    thrust_weight: float = 0.1
    terminal_weight: float = 10.0
    obstacle_weight: float = 1000.0
    safety_margin: float = 1.5  # m

    max_iterations: int = 12
    convergence_tolerance: float = 5e-2
    # converged = min realized relative cost decrease over the final
    # Newton stage <= ftol (scipy L-BFGS-B ftol semantics)
    ftol: float = 1e-6
    cg_iterations: int = 10
    line_search_alphas: tuple = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01)
    # Gauss-Newton warm-up rounds, then full hinge curvature
    newton_full_curvature: bool = True
    gn_warmup_iterations: int = 6

    # adaptive tail refinement (two-phase solve, :func:`_tail_refine`)
    tail_iterations: int = 8
    tail_cg_iterations: int = 25
    tail_capacity: float = 0.25
    tail_line_search_alphas: tuple = (1.0, 0.5, 0.25, 0.05)
    # perturbed restart (phase 3, off by default, :func:`_perturbed_restart`)
    restart_iterations: int = 0
    restart_capacity: float = 0.25
    restart_noise: float = 2.0  # N: thrust-plan jitter std around the init
    cold_start: str = "qp"  # "qp" or "hover" (:func:`initialize_thrusts`)

    # goal-adjacent margin clamp (0 = off; :func:`effective_margins`)
    goal_margin_clamp: float = 0.0
    goal_margin_floor: float = 0.6

    ground_weight: float = 50000.0  # ground-clearance hinge
    min_altitude: float = 0.3  # m
    velocity_bound_weight: float = 1000.0  # +-max_velocity hinge
    tilt_weight: float = 10.0
    thrust_norm_weight: float = 10.0

    mass: float = 1.5  # kg
    gravity: float = 9.81

    max_obstacles: int = 8  # static padded obstacle capacity

    @property
    def weights(self) -> costs.CostWeights:
        return costs.CostWeights(
            position=self.position_weight,
            velocity=self.velocity_weight,
            acceleration=self.acceleration_weight,
            thrust=self.thrust_weight,
            terminal=self.terminal_weight,
            obstacle=self.obstacle_weight,
            ground=self.ground_weight,
            ground_altitude=self.min_altitude,
            velocity_bound=self.velocity_bound_weight,
            max_velocity=self.max_velocity,
            tilt=self.tilt_weight,
            tan_max_tilt=float(np.tan(self.max_tilt_angle)),
            thrust_norm=self.thrust_norm_weight,
            max_thrust_norm=self.max_thrust,
        )

    @property
    def hover_thrust(self) -> float:
        return self.mass * self.gravity

    def thrust_bound_values(self) -> tuple[list, list]:
        """Per-step (lb, ub) as python floats: tilt-limited x/y, [min,max] z."""
        mtt = self.max_thrust * float(np.sin(self.max_tilt_angle))
        return [-mtt, -mtt, self.min_thrust], [mtt, mtt, self.max_thrust]

    def thrust_bounds(self, dtype=torch.float32, device="cpu") -> tuple[Tensor, Tensor]:
        """Per-step (lb, ub) each (3,)."""
        lb, ub = self.thrust_bound_values()
        return (
            torch.tensor(lb, dtype=dtype, device=device),
            torch.tensor(ub, dtype=dtype, device=device),
        )


class SolveResult(NamedTuple):
    """Solver output: dynamics-consistent state sequences + diagnostics."""

    thrusts: Tensor  # (..., N, 3)
    positions: Tensor  # (..., N, 3)
    velocities: Tensor  # (..., N, 3)
    accelerations: Tensor  # (..., N, 3)
    cost: Tensor  # (...)
    converged: Tensor  # (...) bool (ftol criterion, see _finalize)
    grad_norm: Optional[Tensor]  # (...) projected-gradient norm (diagnostic)
    min_improvement: Optional[Tensor] = None


def _gravity(config: SE3MPCConfig, dtype, device) -> Tensor:
    return frames.gravity_vector(
        frames.WorldFrame.ENU, config.gravity, dtype=dtype, device=device
    )


def effective_margins(config: SE3MPCConfig, obstacles: Tensor, goal_pt: Tensor) -> Tensor:
    """Per-obstacle safety margin to ADD to raw radii (..., K).

    With ``config.goal_margin_clamp`` > 0, an obstacle whose inflated ball
    would swallow the goal gets its added margin shrunk so the ball stays
    ``goal_margin_clamp`` m clear of the goal, floored at
    ``goal_margin_floor``; the raw radius is never reduced."""
    margin = config.safety_margin
    if config.goal_margin_clamp <= 0.0:
        return torch.full(
            obstacles.shape[:-1], margin, dtype=obstacles.dtype,
            device=obstacles.device,
        )
    gd = torch.linalg.vector_norm(
        goal_pt[..., None, :] - obstacles[..., :3], dim=-1
    )
    room = gd - obstacles[..., 3] - config.goal_margin_clamp
    return torch.clamp(
        torch.clamp(room, max=margin), config.goal_margin_floor, margin
    )


def make_problem(
    position,
    velocity,
    goal,
    obstacles=None,
    obstacle_mask=None,
    config: SE3MPCConfig = SE3MPCConfig(),
    dtype=torch.float32,
    device=None,
) -> costs.Problem:
    """Build a fixed-shape Problem on ``device``; pads obstacles to
    ``config.max_obstacles`` and adds the safety margin to their radii.

    ``device=None`` keeps ``position``'s device when it is a tensor and
    uses the card otherwise."""
    if device is None:
        device = position.device if isinstance(position, Tensor) else default_device()
    kw = dict(dtype=dtype, device=device)
    K = config.max_obstacles
    p0 = torch.as_tensor(position, **kw)
    v0 = torch.as_tensor(velocity, **kw)
    g = torch.as_tensor(goal, **kw)
    batch = p0.shape[:-1]
    if obstacles is None:
        obs = torch.zeros(batch + (K, 4), **kw)
        mask = torch.zeros(batch + (K,), dtype=torch.bool, device=device)
    else:
        obs_in = torch.as_tensor(obstacles, **kw).clone()
        n = obs_in.shape[-2]
        if n > K:
            raise ValueError(f"{n} obstacles > max_obstacles={K}")
        goal_pt = g[..., -1, :] if g.ndim == len(batch) + 2 else g
        obs_in[..., 3] += effective_margins(config, obs_in, goal_pt)
        obs = torch.cat(
            [obs_in, torch.zeros(obs_in.shape[:-2] + (K - n, 4), **kw)], dim=-2
        )
        if obstacle_mask is None:
            m = torch.ones(obs_in.shape[:-1], dtype=torch.bool, device=device)
        else:
            m = torch.as_tensor(obstacle_mask, dtype=torch.bool, device=device)
        mask = torch.cat(
            [m, torch.zeros(m.shape[:-1] + (K - n,), dtype=torch.bool, device=device)],
            dim=-1,
        )
    return costs.Problem(p0=p0, v0=v0, goal=g, obstacles=obs, obstacle_mask=mask)


@functools.lru_cache(maxsize=32)
def _quadratic_hessian_inverse(config: SE3MPCConfig) -> np.ndarray:
    """Inverse of the constant per-axis quadratic Hessian (float64 solve,
    cached per config): the QP cold start is one matmul with this."""
    H = costs.quadratic_hessian(
        config.prediction_horizon, config.dt, config.mass, config.gravity,
        config.weights,
    )
    return np.linalg.inv(np.asarray(H, np.float64)).astype(np.float32)


def _quadratic_weights(config: SE3MPCConfig) -> costs.CostWeights:
    """The cost weights with every hinge zeroed (the QP part only)."""
    return config.weights._replace(
        obstacle=0.0, ground=0.0, velocity_bound=0.0, tilt=0.0,
        thrust_norm=0.0,
    )


def initialize_thrusts(
    config: SE3MPCConfig, prob: costs.Problem, mode: Optional[str] = None
) -> Tensor:
    """Cold start (..., N, 3). ``mode`` (default ``config.cold_start``):

    - ``"qp"``: the box-clipped unconstrained minimizer of the quadratic
      cost terms, ``u_h - H^-1 g(u_h)`` (the per-axis Hessian is constant);
    - ``"hover"``: hover thrust at every step.
    """
    N = config.prediction_horizon
    batch = prob.p0.shape[:-1]
    dtype, device = prob.p0.dtype, prob.p0.device
    hover = torch.tensor([0.0, 0.0, config.hover_thrust], dtype=dtype, device=device)
    u_h = hover.expand(batch + (N, 3))
    if (mode or config.cold_start) == "hover":
        return u_h.contiguous()
    gvec = _gravity(config, dtype, device)
    g = costs.condensed_grad(
        u_h, prob, _quadratic_weights(config), config.dt, config.mass, gvec
    )
    Hinv = torch.as_tensor(
        _quadratic_hessian_inverse(config), dtype=dtype, device=device
    )
    u_qp = u_h - dynamics.apply_steps(Hinv, g)
    lb, ub = config.thrust_bounds(dtype, device)
    return torch.clamp(u_qp, lb, ub)


def shift_warm_start(config: SE3MPCConfig, u_prev: Tensor) -> Tensor:
    """Shift the previous solution one step and repeat the last thrust."""
    return torch.cat([u_prev[..., 1:, :], u_prev[..., -1:, :]], dim=-2)


def _strip_obstacles(prob: costs.Problem) -> costs.Problem:
    """Zero the obstacle mask so the penalty vanishes from cost, gradient,
    Hessian and diagnostics alike."""
    return prob._replace(obstacle_mask=torch.zeros_like(prob.obstacle_mask))


def _sum_vec(x: Tensor) -> Tensor:
    """Per-scenario sum over the (N, 3) trailing dims, kept for broadcast."""
    return x.sum((-1, -2), keepdim=True)


def _newton_iterate(
    config: SE3MPCConfig,
    prob: costs.Problem,
    u: Tensor,
    use_obstacles: bool,
) -> tuple[Tensor, Tensor]:
    """The fixed-budget projected-Newton loop; returns the final thrusts and
    the minimum realized relative improvement of the final stage.

    Each round: analytic gradient, active set on the thrust box, matrix-free
    Jacobi-preconditioned CG with Steihaug truncation (Gauss-Newton penalty
    blocks for ``gn_warmup_iterations`` rounds, then full curvature with a
    clamped diagonal), and a projected line search that takes the argmin
    over ``[candidates..., current]`` (earliest on ties)."""
    N = config.prediction_horizon
    dt, mass = config.dt, config.mass
    w = config.weights
    dtype, device = u.dtype, u.device
    kw = dict(dtype=dtype, device=device)
    gvec = _gravity(config, dtype, device)
    lb, ub = config.thrust_bounds(dtype, device)
    batch = u.shape[:-2]

    H_axis = torch.as_tensor(
        costs.quadratic_hessian(N, dt, mass, config.gravity, w), **kw
    )
    diag_quad = torch.diagonal(H_axis)[:, None].expand(N, 3)
    S_p_np, S_v_np, _ = dynamics.rollout_matrices(N, float(dt))
    Sp = torch.as_tensor(S_p_np, **kw) / mass
    Sv = torch.as_tensor(S_v_np, **kw) / mass
    SpT = Sp.T.contiguous()
    SvT = Sv.T.contiguous()
    Sp2T = (Sp * Sp).T.contiguous()
    Sv2T = (Sv * Sv).T.contiguous()
    use_vel_hinge = w.velocity_bound > 0.0
    use_penalties = (
        use_obstacles or w.ground > 0.0 or use_vel_hinge
        or w.tilt > 0.0 or w.thrust_norm > 0.0
    )
    alphas = torch.tensor(config.line_search_alphas, **kw).reshape(
        (-1,) + (1,) * u.ndim
    )

    def cost_fn(uu):
        return costs.condensed_cost(uu, prob, w, dt, mass, gvec)

    def newton_round(u, min_imp, full_curv):
        g = costs.condensed_grad(u, prob, w, dt, mass, gvec)
        eps = 1e-6
        at_lo = (u <= lb + eps) & (g > 0)
        at_hi = (u >= ub - eps) & (g < 0)
        free = (~(at_lo | at_hi)).to(dtype)

        Hp = Hv = Hu = None
        if use_penalties:
            Hp, Hv, Hu = costs.penalty_blocks(
                u, prob, w, dt, mass, gvec,
                include_obstacles=use_obstacles, full_curvature=full_curv,
            )

        def matvec(dv):
            dv = dv * free
            out = dynamics.apply_steps(H_axis, dv)
            if Hp is not None:
                y = dynamics.apply_steps(Sp, dv)
                z = (Hp * y[..., None, :]).sum(-1)
                out = out + dynamics.apply_steps(SpT, z)
                if use_vel_hinge:
                    yv = dynamics.apply_steps(Sv, dv)
                    out = out + dynamics.apply_steps(SvT, Hv * yv)
            if Hu is not None:
                out = out + (Hu * dv[..., None, :]).sum(-1)
            return out * free

        diag = diag_quad
        if Hp is not None:
            hp_diag = torch.diagonal(Hp, dim1=-2, dim2=-1)
            diag = diag + dynamics.apply_steps(Sp2T, hp_diag)
            if use_vel_hinge:
                diag = diag + dynamics.apply_steps(Sv2T, Hv)
        if Hu is not None:
            diag = diag + torch.diagonal(Hu, dim1=-2, dim2=-1)
        if full_curv:
            # the full obstacle Hessian can drive diagonal entries
            # negative: clamp to a fraction of the quadratic diagonal
            minv = free / torch.maximum(diag, 0.1 * diag_quad)
        else:
            minv = free / torch.clamp(diag, min=1e-8)

        r = -(g * free)
        z0 = minv * r
        rz = _sum_vec(r * z0)
        d = torch.zeros_like(r)
        p = z0
        alive = torch.ones(rz.shape, dtype=torch.bool, device=device)
        for _ in range(config.cg_iterations):
            ap = matvec(p)
            pap = _sum_vec(p * ap)
            # Steihaug truncation with a scale-invariant curvature guard
            pp = _sum_vec(p * p)
            alive = alive & (pap > 1e-8 * pp)
            ok = alive.to(dtype)
            alpha = ok * rz / torch.clamp(pap, min=1e-12)
            d = d + alpha * p
            r = r - alpha * ap
            z = minv * r
            rz_new = _sum_vec(r * z)
            beta = ok * rz_new / torch.clamp(rz, min=1e-12)
            p = z * ok + beta * p + (1.0 - ok) * p
            rz = torch.where(alive, rz_new, rz)
        if full_curv:
            # negative curvature on the first CG step leaves d = 0: fall
            # back to preconditioned steepest descent
            d = torch.where(_sum_vec(d.abs()) > 0.0, d, z0)
        d = d * free

        cand = torch.clamp(u[None] + alphas * d[None], lb, ub)  # (A, ..., N, 3)
        cur_cost = cost_fn(u)
        stacked = torch.cat([cost_fn(cand), cur_cost[None]], dim=0)
        best_cost, best = torch.min(stacked, dim=0)
        all_cand = torch.cat([cand, u[None]], dim=0)
        index = best[None, ..., None, None].expand((1,) + u.shape)
        u_next = torch.gather(all_cand, 0, index)[0]
        improvement = (cur_cost - best_cost) / (1.0 + best_cost.abs())
        return u_next, torch.minimum(min_imp, improvement)

    imp0 = torch.full(batch, math.inf, **kw)
    n_gn, n_full = cuda_mpc.stage_counts(config)
    min_imp = imp0
    for _ in range(n_gn):
        u, min_imp = newton_round(u, min_imp, False)
    if n_full > 0:
        # stage 2 from the GN basin; the stall tracker restarts
        min_imp = imp0
        for _ in range(n_full):
            u, min_imp = newton_round(u, min_imp, True)
    return u, min_imp


def solve_se3_mpc(
    config: SE3MPCConfig,
    prob: costs.Problem,
    u_init: Optional[Tensor] = None,
    use_obstacles: bool = True,
    with_grad: bool = True,
) -> SolveResult:
    """Single-phase projected-Newton solve on the plain PyTorch path,
    batched over any leading dims of ``prob``."""
    if not use_obstacles:
        prob = _strip_obstacles(prob)
    if u_init is None:
        u_init = initialize_thrusts(config, prob)
    u, min_improvement = _newton_iterate(config, prob, u_init, use_obstacles)
    return _finalize(config, prob, u, min_improvement, with_grad=with_grad)


def _finalize(
    config: SE3MPCConfig,
    prob: costs.Problem,
    u: Tensor,
    min_improvement: Optional[Tensor] = None,
    with_grad: bool = True,
    precomputed: Optional[tuple] = None,
) -> SolveResult:
    """Diagnostics + dynamics-consistent rollout for a final thrust iterate.

    ``converged`` is ``min_improvement <= ftol`` (the minimum realized
    relative cost decrease over the final Newton stage); without
    ``min_improvement`` the projected-gradient norm rule is used.
    ``precomputed`` = (pos, vel, cost) from the kernel's own final exact
    rollout and cost pass."""
    N = config.prediction_horizon
    dtype, device = u.dtype, u.device
    gvec = _gravity(config, dtype, device)
    w = config.weights
    batch = u.shape[:-2]
    lb, ub = config.thrust_bounds(dtype, device)

    grad_norm = None
    if with_grad:
        g = costs.condensed_grad(u, prob, w, config.dt, config.mass, gvec)
        pg = torch.clamp(u - g, lb, ub) - u
        grad_norm = torch.linalg.vector_norm(pg.reshape(batch + (3 * N,)), dim=-1)
    if min_improvement is not None:
        converged = min_improvement <= config.ftol
    elif grad_norm is not None:
        converged = grad_norm < config.convergence_tolerance * 3 * N
    else:
        raise ValueError("with_grad=False requires min_improvement")

    if precomputed is not None:
        pos, vel, cost = precomputed
        acc = u / config.mass + gvec
    else:
        pos, vel, acc = dynamics.rollout_linear(
            u, prob.p0, prob.v0, config.dt, config.mass, gvec
        )
        cost = costs.condensed_cost(u, prob, w, config.dt, config.mass, gvec)
    return SolveResult(
        thrusts=u,
        positions=pos,
        velocities=vel,
        accelerations=acc,
        cost=cost,
        converged=converged,
        grad_norm=grad_norm,
        min_improvement=min_improvement,
    )


def _solve_once(
    config: SE3MPCConfig,
    prob: costs.Problem,
    u_init: Optional[Tensor],
    use_obstacles: bool,
    method: str,
    with_grad: bool = True,
) -> SolveResult:
    """One fixed-budget solve on the selected path (no tail refinement)."""
    if method == "torch":
        return solve_se3_mpc(config, prob, u_init, use_obstacles, with_grad=with_grad)
    if u_init is None:
        u_init = initialize_thrusts(config, prob)
    u, min_improvement, pos, vel, cost = cuda_mpc.solve_thrusts_fused(
        config, prob, u_init, use_obstacles=use_obstacles
    )
    return _finalize(
        config, prob, u, min_improvement, with_grad=with_grad,
        precomputed=(pos, vel, cost),
    )


def _flatten_batch(prob: costs.Problem, res: SolveResult):
    """Flatten leading batch dims of a Problem/SolveResult pair.

    Shared Problem fields (no batch prefix: a shared obstacle set, a single
    goal point) broadcast to the full batch first. Shared vs batched is
    decided by ndim against the field's known trailing rank(s), not by
    shape-prefix equality; the one ambiguous corner (a shared per-step
    (N, 3) goal with one batch dim and N == B) resolves to "batched"."""
    batch_shape = tuple(res.cost.shape)
    B = int(np.prod(batch_shape, dtype=np.int64)) if batch_shape else 1
    nb = len(batch_shape)

    def flat(x, trailing):
        if x is None:
            return None
        shared = any(x.ndim == t for t in trailing)
        batched = any(x.ndim == t + nb for t in trailing)
        if shared and batched:
            batched = tuple(x.shape[:nb]) == batch_shape
            shared = not batched
        if shared:
            x = x.expand(batch_shape + tuple(x.shape))
        return x.reshape((B,) + tuple(x.shape[nb:]))

    prob_trailing = {
        "p0": (1,), "v0": (1,), "goal": (1, 2),
        "obstacles": (2,), "obstacle_mask": (1,), "v_cap": (0,),
    }
    res_trailing = {
        "thrusts": (2,), "positions": (2,), "velocities": (2,),
        "accelerations": (2,), "cost": (0,), "converged": (0,),
        "grad_norm": (0,), "min_improvement": (0,),
    }
    prob_f = costs.Problem(
        **{k: flat(getattr(prob, k), prob_trailing[k]) for k in prob._fields}
    )
    res_f = SolveResult(
        **{k: flat(getattr(res, k), res_trailing[k]) for k in res._fields}
    )
    return prob_f, res_f, batch_shape, B


def _compact_resolve(
    cfg_c: SE3MPCConfig,
    prob_f: costs.Problem,
    res_f: SolveResult,
    u_start_f: Tensor,
    C: int,
    slot: Tensor,
    use_obstacles: bool,
    method: str,
) -> SolveResult:
    """Re-solve the worst cohort in a compact batch and merge improvements.

    ``slot`` is a permutation ranking scenarios re-solve-first (slot i < C
    means scenario i is in the cohort). Results merge back only where the
    re-solved cost is no worse; ``converged`` ORs the two stalls."""
    B = res_f.cost.shape[0]
    idx = torch.empty_like(slot)
    idx[slot] = torch.arange(B, dtype=slot.dtype, device=slot.device)
    idx = idx[:C]

    def take(x):
        return None if x is None else x[idx]

    prob_t = costs.Problem(*[take(x) for x in prob_f])
    ref = _solve_once(
        cfg_c, prob_t, u_start_f[idx], use_obstacles, method, with_grad=False
    )
    ok = ref.cost <= res_f.cost[idx]
    safe_slot = torch.clamp(slot, max=C - 1)
    use_new = (slot < C) & ok[safe_slot]

    def merge(field, new):
        old = getattr(res_f, field)
        if old is None or new is None:
            return old
        sel = use_new.reshape(use_new.shape + (1,) * (new.ndim - 1))
        return torch.where(sel, new[safe_slot], old)

    return SolveResult(
        thrusts=merge("thrusts", ref.thrusts),
        positions=merge("positions", ref.positions),
        velocities=merge("velocities", ref.velocities),
        accelerations=merge("accelerations", ref.accelerations),
        cost=merge("cost", ref.cost),
        converged=res_f.converged | (use_new & ref.converged[safe_slot]),
        # re-solved scenarios keep the phase-1 diagnostic
        grad_norm=res_f.grad_norm,
        min_improvement=merge("min_improvement", ref.min_improvement),
    )


def _unflatten(res: SolveResult, batch_shape) -> SolveResult:
    return SolveResult(
        *[None if x is None else x.reshape(tuple(batch_shape) + tuple(x.shape[1:]))
          for x in res]
    )


def _tail_refine(
    config: SE3MPCConfig,
    prob: costs.Problem,
    res: SolveResult,
    use_obstacles: bool,
    method: str,
) -> SolveResult:
    """Adaptive phase 2: the first ``ceil(tail_capacity * B)`` scenarios
    ranked unconverged-first are re-solved, warm-started from their phase-1
    iterate, for ``tail_iterations`` full-curvature rounds at
    ``tail_cg_iterations`` CG steps with the trimmed line-search grid."""
    prob_f, res_f, batch_shape, B = _flatten_batch(prob, res)
    C = max(1, int(np.ceil(config.tail_capacity * B)))
    cfg_t = config._replace(
        max_iterations=config.tail_iterations,
        cg_iterations=config.tail_cg_iterations,
        newton_full_curvature=True,
        gn_warmup_iterations=0,
        tail_iterations=0,
        restart_iterations=0,
        line_search_alphas=config.tail_line_search_alphas,
    )
    # unconverged first via a stable partition (two prefix sums)
    unconv = (~res_f.converged).to(torch.int64)
    rank_u = torch.cumsum(unconv, 0) - 1
    n_unconv = rank_u[-1] + 1
    rank_c = torch.cumsum(1 - unconv, 0) - 1
    slot = torch.where(unconv == 1, rank_u, n_unconv + rank_c)
    out = _compact_resolve(
        cfg_t, prob_f, res_f, res_f.thrusts, C, slot, use_obstacles, method
    )
    return _unflatten(out, batch_shape)


def _perturbed_restart(
    config: SE3MPCConfig,
    prob: costs.Problem,
    res: SolveResult,
    use_obstacles: bool,
    method: str,
) -> SolveResult:
    """Optional phase 3, basin escape: the most suspicious scenarios
    (cost over the hinge-free quadratic floor, still-unconverged first) are
    re-solved from a jittered cold start under the base staged schedule,
    keeping whichever result costs less. The jitter comes from a
    ``torch.Generator`` seeded with 0 on the problem's device, so the
    result is deterministic; it does not reproduce the JAX package's
    ``jax.random`` draws."""
    prob_f, res_f, batch_shape, B = _flatten_batch(prob, res)
    C = max(1, int(np.ceil(config.restart_capacity * B)))
    cfg_r = config._replace(
        max_iterations=config.restart_iterations,
        tail_iterations=0,
        restart_iterations=0,
    )
    u_cold = initialize_thrusts(config, prob_f)
    gvec = _gravity(config, u_cold.dtype, u_cold.device)
    quad_floor = costs.condensed_cost(
        u_cold, prob_f, _quadratic_weights(config), config.dt, config.mass, gvec
    )
    ratio = res_f.cost / torch.clamp(quad_floor, min=1e-3)
    priority = ratio + torch.where(res_f.converged, 0.0, 1e12)
    order = torch.argsort(-priority, stable=True)
    slot = torch.empty_like(order)
    slot[order] = torch.arange(B, dtype=order.dtype, device=order.device)
    gen = torch.Generator(device=u_cold.device)
    gen.manual_seed(0)
    noise = config.restart_noise * torch.randn(
        u_cold.shape, generator=gen, dtype=u_cold.dtype, device=u_cold.device
    )
    out = _compact_resolve(
        cfg_r, prob_f, res_f, u_cold + noise, C, slot, use_obstacles, method
    )
    return _unflatten(out, batch_shape)


def resolve_method(prob: costs.Problem, method: str) -> str:
    """"auto" -> "cuda" for tensors on a GPU, "torch" on the CPU. "cuda"
    on CPU tensors raises: nothing silently runs on the CPU."""
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    on_cuda = prob.p0.device.type == "cuda"
    if method == "auto":
        return "cuda" if on_cuda else "torch"
    if method == "cuda" and not on_cuda:
        raise ValueError(
            f"method='cuda' needs the problem on a CUDA device, got {prob.p0.device}"
        )
    return method


def solve(
    config: SE3MPCConfig,
    prob: costs.Problem,
    u_init: Optional[Tensor] = None,
    use_obstacles: bool = True,
    method: str = "auto",
) -> SolveResult:
    """Solve dispatcher: ``"cuda"`` = the fused CUDA kernel, ``"torch"`` =
    the plain PyTorch loop, ``"auto"`` = by the problem's device. Both
    paths run the same algorithm. With ``config.tail_iterations`` > 0 a
    compacted second pass refines the unconverged tail."""
    method = resolve_method(prob, method)
    if not use_obstacles:
        prob = _strip_obstacles(prob)
    res = _solve_once(config, prob, u_init, use_obstacles, method)
    if config.tail_iterations > 0:
        res = _tail_refine(config, prob, res, use_obstacles, method)
    if config.restart_iterations > 0:
        res = _perturbed_restart(config, prob, res, use_obstacles, method)
    return res


def extract_trajectory(
    config: SE3MPCConfig, result: SolveResult, start_time
) -> Trajectory:
    """Attitude / body-rate extraction from thrust vectors: R from the
    differentially-flat frame at yaw 0, Euler angles from R, body rates by
    finite-difference vee(R^T dR), thrust magnitudes by norm."""
    u = result.thrusts
    N = config.prediction_horizon
    yaw0 = torch.zeros(u.shape[:-1], dtype=u.dtype, device=u.device)
    Rs = so3.thrust_yaw_to_rotmat(u, yaw0)
    attitudes = so3.rotmat_to_euler(Rs)
    body_rates = so3.body_rates_from_rotmats(Rs, config.dt)
    tmag = torch.linalg.vector_norm(u, dim=-1)
    ok = (tmag > 1e-6)[..., None]
    attitudes = torch.where(ok, attitudes, 0.0)
    body_rates = torch.where(ok, body_rates, 0.0)
    start_time = torch.as_tensor(start_time, dtype=u.dtype, device=u.device)
    ts = start_time[..., None] + config.dt * torch.arange(
        N, dtype=u.dtype, device=u.device
    )
    return Trajectory(
        timestamps=ts,
        positions=result.positions,
        velocities=result.velocities,
        accelerations=result.accelerations,
        attitudes=attitudes,
        body_rates=body_rates,
        thrusts=tmag,
        yaws=attitudes[..., 2],
        yaw_rates=body_rates[..., 2],
    )


def emergency_trajectory(config: SE3MPCConfig, state: DroneState) -> Trajectory:
    """Hover-in-place fallback."""
    N = config.prediction_horizon
    pos0 = state.position
    ts = state.timestamp[..., None] + config.dt * torch.arange(
        N, dtype=pos0.dtype, device=pos0.device
    )
    pos = pos0[..., None, :].expand(pos0.shape[:-1] + (N, 3)).clone()
    zeros = torch.zeros_like(pos)
    return Trajectory(
        timestamps=ts, positions=pos, velocities=zeros, accelerations=zeros.clone()
    )


def is_plan_valid(trajectory: Trajectory) -> Tensor:
    """Vectorized validity check: finite positions, altitude >= 0.1 m,
    |velocity| <= 20 m/s."""
    pos = trajectory.positions
    valid = torch.isfinite(pos).all(-1).all(-1) & (pos[..., 2] >= 0.1).all(-1)
    if trajectory.velocities is not None:
        valid = valid & (trajectory.velocities.abs() <= 20.0).all(-1).all(-1)
    return valid


class SE3MPCPlanner(BasePlanner):
    """Stateful facade (set_goal / add_obstacle / plan_trajectory) over the
    pure solver, on one device. The warm-start thrust plan stays on that
    device between replans. Registered as ``"se3_mpc"`` in
    :class:`~dart_planner_tpu_torch.planning.base.PlannerFactory`."""

    def __init__(self, config: SE3MPCConfig | dict | None = None, device=None):
        if isinstance(config, dict):
            config = SE3MPCConfig(**config)
        super().__init__(config._asdict() if config else None)
        self.config = config or SE3MPCConfig()
        self.device = resolve_device(device)
        self.goal_position: Optional[np.ndarray] = None
        self.last_solution: Optional[Tensor] = None
        self.warm_start_enabled = True
        # replans answered with the hover fallback (an invalid plan)
        self.emergency_plans = 0

    def set_goal(self, goal_position) -> None:
        self.goal_position = np.asarray(goal_position, np.float32)

    def add_obstacle(self, center, radius: float) -> None:
        if len(self.obstacles) >= self.config.max_obstacles:
            self.obstacles.pop(0)  # keep the most recent K obstacles
        self.obstacles.append((np.asarray(center, np.float32), float(radius)))

    def clear_obstacles(self) -> None:
        self.obstacles.clear()

    def _problem(self, state: DroneState) -> costs.Problem:
        obs = None
        if self.obstacles:
            obs = np.stack(
                [np.concatenate([c, [r]]) for c, r in self.obstacles]
            ).astype(np.float32)
        return make_problem(
            state.position.to(self.device),
            state.velocity.to(self.device),
            self.goal_position,
            obstacles=obs,
            config=self.config,
            device=self.device,
        )

    def plan_trajectory(self, state: DroneState, goal_position) -> Trajectory:
        """sense -> plan -> act."""
        t0 = time.perf_counter()
        goal = np.asarray(goal_position, np.float32)
        if (
            self.goal_position is None
            or np.linalg.norm(self.goal_position - goal) > 0.5
        ):
            self.set_goal(goal)  # goal-change threshold
        prob = self._problem(state)
        u0 = None
        if self.warm_start_enabled and self.last_solution is not None:
            u0 = shift_warm_start(self.config, self.last_solution)
        result = solve(self.config, prob, u0, use_obstacles=bool(self.obstacles))
        self.last_solution = result.thrusts
        traj = extract_trajectory(
            self.config, result, state.timestamp.to(self.device)
        )
        self._update_planning_stats(
            (time.perf_counter() - t0) * 1000.0,
            success=bool(result.converged.all()),
        )
        if not bool(is_plan_valid(traj).all()):
            self.emergency_plans += 1
            return emergency_trajectory(
                self.config,
                state.replace(
                    timestamp=state.timestamp.to(self.device),
                    position=state.position.to(self.device),
                ),
            )
        return traj

    def get_planning_stats(self) -> dict:
        st = self.planning_stats
        if not st["planning_times"]:
            return {}
        return {
            "mean_planning_time_ms": float(np.mean(st["planning_times"])),
            "max_planning_time_ms": float(np.max(st["planning_times"])),
            "success_rate": st["successful_plans"] / max(st["total_plans"], 1),
            "total_plans": st["total_plans"],
            "emergency_plans": self.emergency_plans,
        }

    def reset_performance_tracking(self) -> None:
        self.reset_stats()
        self.emergency_plans = 0
