"""The port's planning slice (dart_planner_tpu_torch/planning/se3_mpc.py and
runtime/fast_path.py) against the JAX package on the same numpy inputs.

The two-phase solve is compared on identical batches (its tail cohort is
batch-dependent by design). Tolerances as in the JAX package's own
contracts: convex instances follow one Newton path (thrusts 2e-3, costs
1e-5 relative); obstacle instances may branch at line-search near-ties, so
their contract is aggregate.
"""

import numpy as np
import pytest
import torch

from dart_planner_tpu.common.types import DroneState as JDroneState
from dart_planner_tpu.planning import se3_mpc as J
from dart_planner_tpu_torch import DroneState, interop
from dart_planner_tpu_torch.ops import costs as tcosts
from dart_planner_tpu_torch.planning import PlannerFactory
from dart_planner_tpu_torch.planning import se3_mpc as T
from dart_planner_tpu_torch.runtime import rt_executor
from dart_planner_tpu_torch.runtime.fast_path import PlannerFastPath, measure_latency

CFG = T.SE3MPCConfig(prediction_horizon=8, max_iterations=6, cg_iterations=10)
CONVEX = CFG._replace(
    ground_weight=0.0, velocity_bound_weight=0.0, tilt_weight=0.0,
    thrust_norm_weight=0.0,
)


def _np(x):
    return np.asarray(x, np.float32)


def _arrays(seed, batch, n_obs=3):
    rng = np.random.default_rng(seed)
    obs = np.concatenate(
        [rng.normal(0, 4, (batch, n_obs, 3)), rng.uniform(0.3, 1.2, (batch, n_obs, 1))],
        axis=-1,
    ).astype(np.float32)
    p0 = rng.normal(0, 2, (batch, 3)).astype(np.float32) + np.float32([0, 0, 5])
    v0 = rng.normal(0, 1, (batch, 3)).astype(np.float32)
    goal = rng.normal(0, 3, (batch, 3)).astype(np.float32) + np.float32([0, 0, 5])
    return p0, v0, goal, obs


def _both(config, arrays, use_obstacles=True):
    p0, v0, goal, obs = arrays
    obs = obs if use_obstacles else None
    jcfg = J.SE3MPCConfig(**config._asdict())
    pj = J.make_problem(p0, v0, goal, obstacles=obs, config=jcfg)
    pt = T.make_problem(p0, v0, goal, obstacles=obs, config=config, device="cpu")
    return jcfg, pj, pt


@pytest.mark.parametrize("clamp", [0.0, 0.5])
def test_make_problem_matches_jax(clamp):
    config = CFG._replace(goal_margin_clamp=clamp)
    p0, v0, goal, obs = _arrays(0, 5)
    goal[0] = obs[0, 0, :3]  # a goal inside an inflated ball
    jcfg, pj, pt = _both(config, (p0, v0, goal, obs))
    for a, b in zip(pt, pj):
        if a is None:
            assert b is None
            continue
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    assert pt.obstacles.shape == (5, config.max_obstacles, 4)
    with pytest.raises(ValueError):
        T.make_problem(p0, v0, goal, obstacles=np.zeros((5, 9, 4), np.float32), config=config,
                       device="cpu")


@pytest.mark.parametrize("mode", ["qp", "hover"])
def test_initialize_thrusts_matches_jax(mode):
    jcfg, pj, pt = _both(CFG, _arrays(1, 8))
    ref = _np(J.initialize_thrusts(jcfg, pj, mode=mode))
    out = T.initialize_thrusts(CFG, pt, mode=mode).numpy()
    # thrusts ~15 N; the QP step is one (N, N) matmul of a float32 gradient
    np.testing.assert_allclose(out, ref, atol=1e-4)
    lb, ub = CFG.thrust_bounds()
    assert torch.all(torch.as_tensor(out) >= lb) and torch.all(torch.as_tensor(out) <= ub)


def test_two_phase_solve_convex_matches_jax():
    jcfg, pj, pt = _both(CONVEX, _arrays(2, 8), use_obstacles=False)
    u0 = _np(J.initialize_thrusts(jcfg, pj))
    rj = J.solve(jcfg, pj, u0, method="xla", use_obstacles=False)
    rt = T.solve(CONVEX, pt, torch.tensor(u0), use_obstacles=False)
    np.testing.assert_allclose(rt.thrusts.numpy(), _np(rj.thrusts), atol=2e-3)
    np.testing.assert_allclose(rt.cost.numpy(), _np(rj.cost), rtol=1e-5)
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    np.testing.assert_allclose(rt.positions.numpy(), _np(rj.positions), atol=2e-3)
    np.testing.assert_allclose(rt.grad_norm.numpy(), _np(rj.grad_norm), rtol=1e-3, atol=1e-3)


def test_two_phase_solve_obstacles_aggregate():
    config = CFG._replace(tail_capacity=0.5)
    jcfg, pj, pt = _both(config, _arrays(3, 16))
    u0 = _np(J.initialize_thrusts(jcfg, pj))
    rj = J.solve(jcfg, pj, u0, method="xla")
    rt = T.solve(config, pt, torch.tensor(u0))
    cj, ct = _np(rj.cost), rt.cost.numpy()
    assert np.mean(ct) <= np.mean(cj) * 1.05 and np.mean(cj) <= np.mean(ct) * 1.05
    c0 = _np(J._finalize(jcfg, pj, u0).cost)
    assert np.all(ct <= c0 + 1e-3)
    close = np.abs(rt.thrusts.numpy() - _np(rj.thrusts)) < 0.05
    assert close.all(axis=(-1, -2)).mean() >= 0.5
    assert abs(rt.converged.float().mean().item() - np.asarray(rj.converged).mean()) <= 0.15
    # the tail pass never regresses phase 1 on the port
    r1 = T.solve(config._replace(tail_iterations=0), pt, torch.tensor(u0))
    assert torch.all(rt.cost <= r1.cost + 1e-5)
    assert not torch.any(r1.converged & ~rt.converged)


def test_extract_trajectory_matches_jax():
    jcfg, pj, pt = _both(CFG, _arrays(4, 4))
    rj = J.solve(jcfg, pj, method="xla")
    res = T.SolveResult(
        **{k: None if v is None else torch.as_tensor(np.array(v)).to(
            torch.bool if np.asarray(v).dtype == bool else torch.float32)
           for k, v in rj._asdict().items()}
    )
    res = res._replace(thrusts=res.thrusts.clone())
    res.thrusts[0, 3] = 0.0  # a zero-thrust step: attitude and rates zeroed
    tj = J.extract_trajectory(
        jcfg, rj._replace(thrusts=np.asarray(res.thrusts.numpy())), 2.5
    )
    tt = T.extract_trajectory(CFG, res, 2.5)
    for name in ("timestamps", "positions", "attitudes", "body_rates", "thrusts",
                 "yaws", "yaw_rates"):
        np.testing.assert_allclose(
            getattr(tt, name).numpy(), _np(getattr(tj, name)), atol=1e-5, err_msg=name
        )
    assert tt.horizon == CFG.prediction_horizon


def test_method_selection_on_cpu():
    _, _, pt = _both(CFG, _arrays(5, 2))
    assert T.resolve_method(pt, "auto") == "torch"
    with pytest.raises(ValueError, match="CUDA"):
        T.solve(CFG, pt, method="cuda")
    with pytest.raises(ValueError):
        T.solve(CFG, pt, method="xla")


def test_planner_verify_recipe_matches_jax():
    """The verify recipe: obstacle at (2.5, 0, 2), r=0.5, from (0, 0, 2)
    toward (5, 0, 3), three warm-started replans on both packages."""
    cfg = T.SE3MPCConfig(prediction_horizon=12)
    jp = J.SE3MPCPlanner(J.SE3MPCConfig(**cfg._asdict()))
    tp = T.SE3MPCPlanner(cfg, device="cpu")
    for p in (jp, tp):
        p.add_obstacle(center=(2.5, 0.0, 2.0), radius=0.5)
    js = JDroneState.create(timestamp=0.0, position=(0.0, 0.0, 2.0))
    ts = DroneState.create(timestamp=0.0, position=(0.0, 0.0, 2.0), device="cpu")
    goal = (5.0, 0.0, 3.0)
    for _ in range(3):
        jt = jp.plan_trajectory(js, goal)
        tt = tp.plan_trajectory(ts, goal)
        np.testing.assert_allclose(
            tt.positions.numpy()[-1], _np(jt.positions)[-1], atol=1e-3
        )
    assert np.linalg.norm(tt.positions.numpy()[-1] - np.asarray(goal)) < np.linalg.norm(
        np.asarray([0.0, 0.0, 2.0]) - np.asarray(goal)
    )
    assert tp.get_planning_stats()["total_plans"] == 3
    assert tp.last_solution.shape == (12, 3)


def test_emergency_trajectory_and_plan_validity():
    cfg = T.SE3MPCConfig(prediction_horizon=6)
    state = DroneState.create(timestamp=1.0, position=(0.5, -1.0, 2.0), device="cpu")
    em = T.emergency_trajectory(cfg, state)
    jem = J.emergency_trajectory(
        J.SE3MPCConfig(prediction_horizon=6),
        JDroneState.create(timestamp=1.0, position=(0.5, -1.0, 2.0)),
    )
    for name in ("timestamps", "positions", "velocities", "accelerations"):
        np.testing.assert_allclose(getattr(em, name).numpy(), _np(getattr(jem, name)))
    assert bool(T.is_plan_valid(em))
    bad = em.replace(positions=em.positions.clone())
    bad.positions[0, 2] = float("nan")
    assert not bool(T.is_plan_valid(bad))
    low = em.replace(positions=em.positions.clone())
    low.positions[3, 2] = 0.05
    assert not bool(T.is_plan_valid(low))
    fast = em.replace(velocities=torch.full_like(em.velocities, 25.0))
    assert not bool(T.is_plan_valid(fast))


def test_restart_never_regresses():
    """Phase-3 perturbed restart on the port: costs never regress vs the
    two-phase result, converged never un-converges, the result is
    deterministic, and an under-budgeted phase 1 improves somewhere."""
    B = 32
    base = CFG._replace(max_iterations=2, gn_warmup_iterations=2,
                        tail_iterations=2, tail_capacity=0.25)
    p0, v0, goal, obs = _arrays(7, B, n_obs=4)
    prob = T.make_problem(p0, v0, goal, obstacles=obs, config=base, device="cpu")
    u0 = T.initialize_thrusts(base, prob)
    r2 = T.solve(base, prob, u0)
    cfg_r = base._replace(restart_iterations=8, restart_capacity=0.5)
    r3 = T.solve(cfg_r, prob, u0)
    assert torch.all(r3.cost <= r2.cost + 1e-5)
    assert torch.any(r3.cost < r2.cost - 1e-3)
    assert not torch.any(r2.converged & ~r3.converged)
    r3b = T.solve(cfg_r, prob, u0)
    assert torch.equal(r3.cost, r3b.cost)


def test_tail_refine_shared_fields_with_coincident_batch_dims():
    """Shared goal / obstacles are told from batched ones by rank, also when
    B == 3 == len(goal) or B == K."""
    base = CFG._replace(max_iterations=4, tail_iterations=4, tail_capacity=1.0)
    rng = np.random.default_rng(3)
    for B, K in [(3, 4), (4, 4)]:
        obs = np.concatenate(
            [rng.normal(0, 3, (K, 3)), rng.uniform(0.4, 1.0, (K, 1))], axis=-1
        ).astype(np.float32)
        p0 = rng.normal(0, 2, (B, 3)).astype(np.float32) + np.float32([0, 0, 5])
        v0 = rng.normal(0, 1, (B, 3)).astype(np.float32)
        goal = np.asarray([4.0, -2.0, 6.0], np.float32)
        shared = T.make_problem(p0, v0, goal, obstacles=obs, config=base, device="cpu")
        bcast = T.make_problem(p0, v0, np.tile(goal, (B, 1)),
                               obstacles=np.tile(obs[None], (B, 1, 1)), config=base,
                               device="cpu")
        u0 = T.initialize_thrusts(base, shared)
        rs = T.solve(base, shared, u0)
        rb = T.solve(base, bcast, u0)
        torch.testing.assert_close(rs.cost, rb.cost, rtol=1e-5, atol=0)
        torch.testing.assert_close(rs.thrusts, rb.thrusts, rtol=1e-4, atol=1e-4)


def test_planner_registry_and_obstacle_capacity():
    planner = PlannerFactory.create("se3_mpc", device="cpu")
    assert isinstance(planner, T.SE3MPCPlanner)
    small = T.SE3MPCPlanner({"prediction_horizon": 8, "max_obstacles": 2}, device="cpu")
    for i in range(3):
        small.add_obstacle((float(i), 0.0, 2.0), 0.5)
    assert [float(c[0]) for c, _ in small.obstacles] == [1.0, 2.0]
    small.clear_obstacles()
    assert small.obstacles == [] and small.get_planning_stats() == {}


def test_fast_path_replan_on_cpu():
    fp = PlannerFastPath(T.SE3MPCConfig(prediction_horizon=8, max_iterations=4), device="cpu")
    sp = fp.replan([0.0, 0.0, 3.0], [0.0, 0.0, 0.0], [4.0, 2.0, 4.0])
    assert sp.shape == (13,) and sp.dtype == np.float32
    assert np.all(np.isfinite(sp)) and sp[12] > 0.0
    assert np.linalg.norm(sp[:3] - [4.0, 2.0, 4.0]) < np.linalg.norm([4.0, 2.0, 1.0])
    u1 = fp._u.clone()
    fp.replan([0.1, 0.0, 3.0], [0.0, 0.0, 0.0], [4.0, 2.0, 4.0])
    assert fp._u.device == fp.device and not torch.equal(u1, fp._u)
    loop = rt_executor.PythonControlLoop(frequency_hz=200.0)
    loop.set_gains([2.0, 2.0, 4.0], [0.0] * 3, [1.0] * 3, [4.0] * 3, [0.0] * 3, [0.5] * 3)
    loop.start()
    try:
        stats = measure_latency(fp, loop, n_replans=3)
    finally:
        loop.stop()
    assert stats["n_replans"] == 3
    assert stats["planner_to_actuator_p95_ms"] >= stats["planning_host_p95_ms"] > 0.0
    assert "tunnel_rtt_p50_ms" not in stats


def test_interop_round_trip():
    jcfg, pj, _ = _both(CFG, _arrays(8, 3))
    cfg = interop.config_from_jax_fields(jcfg)
    assert cfg == CFG and interop.config_from_jax_fields(jcfg._asdict()) == CFG
    prob = interop.problem_from_numpy(pj)
    assert prob.obstacle_mask.dtype == torch.bool and prob.v_cap is None
    for a, b in zip(prob, pj):
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(a.numpy().dtype))
    res = T.solve(cfg._replace(tail_iterations=0), prob)
    out = interop.result_to_numpy(res)
    assert set(out) == set(T.SolveResult._fields)
    assert out["thrusts"].shape == (3, 8, 3) and out["converged"].dtype == bool
    assert isinstance(prob, tcosts.Problem)
    with pytest.raises(TypeError):
        interop.problem_from_numpy([1, 2, 3])


def _norm_sources():
    """``finalize_grad_norms`` by its ``source`` label."""
    from dart_planner_tpu_torch.common.metrics import get_metrics

    return {dict(k)["source"]: n for k, n in get_metrics().series("finalize_grad_norms").items()}


def _rose(before, after):
    return {s: after.get(s, 0) - before.get(s, 0) for s in ("kernel", "dense")}


@pytest.mark.parametrize("given", ["kernel", "none", "plain"])
def test_finalize_takes_a_given_norm_else_runs_the_dense_gradient(monkeypatch, given):
    """``_finalize`` passes a solve's record through: the kernel's norm (a
    marker here), none where none was asked for, and the plain twin's dense
    norm, which is the JAX package's. It runs no gradient of its own
    (``condensed_grad`` raises while it runs) and counts nothing; its
    accelerations are ``u / m + g`` and ``converged`` is the ftol rule.
    ``solve_once``, where the solver is chosen, adds one to
    ``finalize_grad_norms`` under the record's source (``kernel``, ``dense``)
    and none for a solve without a norm."""
    from dart_planner_tpu_torch.ops import cuda_mpc

    jcfg, pj, prob = _both(CFG, _arrays(5, 4))
    u = T.initialize_thrusts(CFG, prob)
    gvec = torch.tensor([0.0, 0.0, -CFG.gravity])
    if given == "plain":
        # no Newton round: the record's norm is that of the cold start
        record = T.solve_thrusts_plain(CFG._replace(max_iterations=0), prob, u, with_grad=True)
    else:
        pos, vel, _ = T.dynamics.rollout_linear(u, prob.p0, prob.v0, CFG.dt, CFG.mass, gvec)
        cost = tcosts.condensed_cost(u, prob, CFG.weights, CFG.dt, CFG.mass, gvec)
        norm = torch.arange(1.0, 5.0) if given == "kernel" else None
        record = cuda_mpc.ThrustSolve(u, torch.tensor([0.0, 1.0, 0.0, 1.0]), pos, vel, cost,
                                      norm)

    def refuse(*args, **kwargs):
        raise AssertionError("a dense gradient in _finalize")

    with monkeypatch.context() as m:
        m.setattr(tcosts, "condensed_grad", refuse)
        before = _norm_sources()
        res = T._finalize(CFG, record)
        assert _rose(before, _norm_sources()) == {"kernel": 0, "dense": 0}
    assert res.grad_norm is record.grad_norm
    assert torch.equal(res.positions, record.positions) and torch.equal(res.cost, record.cost)
    assert torch.equal(res.accelerations, u / CFG.mass + gvec)
    assert torch.equal(res.converged, record.min_improvement <= CFG.ftol)
    if given == "plain":
        want = J._finalize(jcfg, pj, u.numpy(), np.zeros(4, np.float32)).grad_norm
        np.testing.assert_allclose(res.grad_norm.numpy(), _np(want), rtol=1e-4, atol=1e-4)
    if given == "kernel":
        monkeypatch.setattr(T, "resolve_method", lambda prob, method: "cuda")
        monkeypatch.setattr(cuda_mpc, "solve_thrusts_fused", lambda *args, **kwargs: record)
    before = _norm_sources()
    out = T.solve_once(CFG, prob, u, True, "torch", with_grad=given != "none")
    assert _rose(before, _norm_sources()) == {"kernel": int(given == "kernel"),
                                              "dense": int(given == "plain")}
    assert (out.grad_norm is None) == (given == "none")


def test_plain_solve_counts_one_dense_norm():
    """A two-phase solve on the plain path computes phase 1's norm by the
    dense gradient, once: the tail pass asks for none, and ``/metrics``
    shows the counter as ``dart_finalize_grad_norms_total``."""
    from dart_planner_tpu_torch.common.metrics import get_metrics

    _, _, prob = _both(CFG, _arrays(6, 4))
    before = _norm_sources()
    res = T.solve(CFG, prob, method="torch")
    assert res.grad_norm.shape == (4,)
    assert _rose(before, _norm_sources()) == {"kernel": 0, "dense": 1}
    assert 'dart_finalize_grad_norms_total{source="dense"}' in (
        get_metrics().prometheus_exposition())
