"""The port's ops (dynamics, costs, SO(3)) against the JAX package on the
same float32 numpy inputs.

Tolerances: float32 on both sides, sums in another order. Rollouts 1e-5
absolute, costs 1e-5 relative, the analytic gradient 1e-5 relative to the
gradient's scale (``jax.grad`` is the reference), penalty blocks 1e-4
absolute (plus 1e-6 relative: entries reach 1e3-1e5, where one float32
ulp alone exceeds 1e-4 and a sum of a few terms rounds a few ulps apart),
SO(3) maps 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dart_planner_tpu.common import frames as jframes
from dart_planner_tpu.ops import costs as jcosts
from dart_planner_tpu.ops import dynamics as jdyn
from dart_planner_tpu.ops import so3 as jso3
from dart_planner_tpu.planning import se3_mpc as J
from dart_planner_tpu_torch.common import frames as tframes
from dart_planner_tpu_torch.ops import costs as tcosts
from dart_planner_tpu_torch.ops import dynamics as tdyn
from dart_planner_tpu_torch.ops import so3 as tso3
from dart_planner_tpu_torch.planning import se3_mpc as T

N = 8
DT, MASS = 0.1, 1.5


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _gvec():
    g = jframes.gravity_vector(jframes.WorldFrame.ENU, 9.81).astype(jnp.float32)
    return g, tframes.gravity_vector(device="cpu")


def _thrusts(rng, batch=(4,)):
    u = rng.normal(0, 4, batch + (N, 3)).astype(np.float32)
    u[..., 2] += 14.7
    return u


@pytest.mark.parametrize("fn", ["rollout_linear", "rollout_scan"])
def test_rollouts_match_jax(fn):
    rng = np.random.default_rng(0)
    u = _thrusts(rng)
    p0 = rng.normal(0, 2, (4, 3)).astype(np.float32)
    v0 = rng.normal(0, 1, (4, 3)).astype(np.float32)
    gj, gt = _gvec()
    ref = getattr(jdyn, fn)(u, p0, v0, DT, MASS, gj)
    out = getattr(tdyn, fn)(_t(u), _t(p0), _t(v0), DT, MASS, gt)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=1e-5)
    # and the two torch rollouts agree with each other
    other = getattr(tdyn, "rollout_scan" if fn == "rollout_linear" else "rollout_linear")(
        _t(u), _t(p0), _t(v0), DT, MASS, gt
    )
    for a, b in zip(out, other):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_rollout_matrices_and_quadratic_hessian_are_identical():
    for a, b in zip(tdyn.rollout_matrices(N, DT), jdyn.rollout_matrices(N, DT)):
        assert np.array_equal(a, b)
    cfg = T.SE3MPCConfig(prediction_horizon=N)
    jw = J.SE3MPCConfig(prediction_horizon=N).weights
    Ht = tcosts.quadratic_hessian(N, DT, MASS, 9.81, cfg.weights)
    Hj = jcosts.quadratic_hessian(N, DT, MASS, 9.81, jw)
    assert np.array_equal(Ht, Hj)
    assert np.array_equal(
        T._quadratic_hessian_inverse(cfg),
        J._quadratic_hessian_inverse(J.SE3MPCConfig(prediction_horizon=N)),
    )


def _problems(rng, batch=4, v_cap=False, per_step_goal=False):
    """(jax Problem, torch Problem, weights) with every hinge active
    somewhere: spheres near the path, low altitudes, fast starts."""
    obs = np.concatenate(
        [rng.normal(0, 2, (batch, 3, 3)) + [0, 0, 2], rng.uniform(0.5, 2.0, (batch, 3, 1))],
        axis=-1,
    ).astype(np.float32)
    p0 = rng.normal(0, 1, (batch, 3)).astype(np.float32) + np.float32([0, 0, 0.5])
    v0 = rng.normal(0, 6, (batch, 3)).astype(np.float32)
    if per_step_goal:
        goal = rng.normal(0, 3, (batch, N, 3)).astype(np.float32)
    else:
        goal = rng.normal(0, 3, (batch, 3)).astype(np.float32)
    jcfg = J.SE3MPCConfig(prediction_horizon=N, max_velocity=4.0)
    tcfg = T.SE3MPCConfig(**jcfg._asdict())
    pj = J.make_problem(p0, v0, goal, obstacles=obs, config=jcfg)
    pt = T.make_problem(p0, v0, goal, obstacles=obs, config=tcfg, device="cpu")
    if v_cap:
        cap = rng.uniform(1.0, 5.0, (batch,)).astype(np.float32)
        pj = pj._replace(v_cap=jnp.asarray(cap))
        pt = pt._replace(v_cap=_t(cap))
    return pj, pt, jcfg.weights, tcfg.weights


CASES = {
    "point_goal": dict(),
    "v_cap": dict(v_cap=True),
    "per_step_goal": dict(per_step_goal=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_condensed_cost_matches_jax(case):
    rng = np.random.default_rng(1)
    pj, pt, wj, wt = _problems(rng, **CASES[case])
    u = _thrusts(rng)
    gj, gt = _gvec()
    ref = _np(jcosts.condensed_cost(u, pj, wj, DT, MASS, gj))
    out = tcosts.condensed_cost(_t(u), pt, wt, DT, MASS, gt).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5)
    # every hinge is live in this batch, so the comparison covers each term
    assert np.all(ref > 0)


@pytest.mark.parametrize("case", list(CASES))
def test_analytic_gradient_matches_jax_grad(case):
    rng = np.random.default_rng(2)
    pj, pt, wj, wt = _problems(rng, **CASES[case])
    u = _thrusts(rng)
    gj, gt = _gvec()
    ref = _np(jcosts.condensed_grad(u, pj, wj, DT, MASS, gj))
    out = tcosts.condensed_grad(_t(u), pt, wt, DT, MASS, gt).numpy()
    # relative to the gradient's scale: single components near zero carry
    # the float32 cancellation of terms of the largest component's size
    scale = np.abs(ref).max(axis=(-1, -2), keepdims=True)
    rel = (np.abs(out - ref) / scale).max()
    assert rel <= 1e-5, rel


@pytest.mark.parametrize("full_curvature", [False, True])
@pytest.mark.parametrize("include_obstacles", [True, False])
def test_penalty_blocks_match_jax(full_curvature, include_obstacles):
    rng = np.random.default_rng(3)
    pj, pt, wj, wt = _problems(rng, v_cap=True)
    u = _thrusts(rng)
    gj, gt = _gvec()
    ref = jcosts.penalty_blocks(
        u, pj, wj, DT, MASS, gj, include_obstacles=include_obstacles,
        full_curvature=full_curvature,
    )
    out = tcosts.penalty_blocks(
        _t(u), pt, wt, DT, MASS, gt, include_obstacles=include_obstacles,
        full_curvature=full_curvature,
    )
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=1e-4, rtol=1e-6)
    assert np.abs(_np(ref[0])).max() > 100.0  # the obstacle/ground blocks are live


def test_obstacle_penalty_and_effective_vmax():
    rng = np.random.default_rng(4)
    pj, pt, wj, wt = _problems(rng, v_cap=True)
    pos = rng.normal(0, 2, (4, N, 3)).astype(np.float32) + np.float32([0, 0, 2])
    np.testing.assert_allclose(
        tcosts.obstacle_penalty(_t(pos), pt.obstacles, pt.obstacle_mask).numpy(),
        _np(jcosts.obstacle_penalty(pos, pj.obstacles, pj.obstacle_mask)),
        rtol=1e-5,
    )
    np.testing.assert_array_equal(
        tcosts.effective_vmax(pt, wt).numpy(), _np(jcosts.effective_vmax(pj, wj))
    )
    assert tcosts.effective_vmax(pt._replace(v_cap=None), wt) == wt.max_velocity


# --- SO(3) ---------------------------------------------------------------


def _so3_inputs(rng):
    v = rng.normal(0, 1, (6, 3)).astype(np.float32)
    euler = rng.uniform(-1.2, 1.2, (6, 3)).astype(np.float32)
    q = rng.normal(0, 1, (6, 4)).astype(np.float32)
    q[0] = 0.0  # degenerate quaternion -> identity
    thrust = rng.normal(0, 3, (6, 3)).astype(np.float32) + np.float32([0, 0, 10])
    thrust[0] = 0.0  # zero thrust -> identity attitude
    thrust[1] = [0.0, 0.0, 5.0]
    thrust[2] = [8.0, 0.0, 0.1]  # yaw axis nearly parallel to b3
    yaw = rng.uniform(-3, 3, (6,)).astype(np.float32)
    yaw[2] = 0.0
    return v, euler, q, thrust, yaw


SO3_CASES = [
    "hat", "vee", "euler_to_rotmat", "rotmat_to_euler", "quat_to_rotmat",
    "normalize", "thrust_yaw_to_rotmat", "attitude_error",
    "body_rates_from_rotmats", "exp_so3", "log_so3", "mm",
]


@pytest.mark.parametrize("name", SO3_CASES)
def test_so3_matches_jax(name):
    rng = np.random.default_rng(5)
    v, euler, q, thrust, yaw = _so3_inputs(rng)
    R = _np(jso3.euler_to_rotmat(euler))
    R2 = _np(jso3.euler_to_rotmat(euler[::-1].copy()))
    small = v * 1e-7
    args = {
        "hat": (v,),
        "vee": (_np(jso3.hat(v)),),
        "euler_to_rotmat": (euler,),
        "rotmat_to_euler": (R,),
        "quat_to_rotmat": (q,),
        "normalize": (np.concatenate([v, small]),),
        "thrust_yaw_to_rotmat": (thrust, yaw),
        "attitude_error": (R, R2),
        "body_rates_from_rotmats": (R[None], 0.1),
        "exp_so3": (np.concatenate([v, small]),),
        "log_so3": (np.concatenate([R, _np(jso3.exp_so3(np.float32([[3.1414, 0, 0]])))]),),
        "mm": (R, R2),
    }[name]
    ref = _np(getattr(jso3, name)(*args))
    out = getattr(tso3, name)(*[_t(a) if isinstance(a, np.ndarray) else a for a in args])
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
