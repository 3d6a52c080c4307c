"""The port's solver kernel module (dart_planner_tpu_torch/ops/cuda_mpc.py).

On the CPU: the plain version ``solve_thrusts_plain`` is held against the JAX
package's fused Pallas kernel (interpret mode) and its XLA path on the same
numpy inputs; the kernel's constant block is checked by applying it the way
the kernel does. On a CUDA device (tests marked ``cuda``): the hand-written
kernel is held against the plain loop. The CUDA tests import nothing of JAX,
so they run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_cuda_mpc.py -m cuda

Tolerances: where the Newton path cannot branch (one round at CG-2, or the
JAX package's convex regime short of its float32 cost ties) thrusts agree
to 2e-3 and costs to 1e-5 relative (float32 sums in another order). With
the full CG-10 budget the
iterates are sensitive to rounding (measured on an H100: the plain loop on
the GPU and on the CPU differ by ~1 N in thrust at equal cost at N=20), and
obstacle instances branch at line-search near-ties, so there the contract
is aggregate (mean cost within 5%, descent from the cold start, at least
half the scenarios within 0.05 in thrust), as in tests/test_pallas_mpc.py.
"""

import math

import numpy as np
import pytest
import torch

from dart_planner_tpu_torch.ops import cuda_mpc, dynamics
from dart_planner_tpu_torch.planning import se3_mpc as T

CFG = T.SE3MPCConfig(
    prediction_horizon=8, max_iterations=4, cg_iterations=10, tail_iterations=0
)
CONVEX = CFG._replace(
    ground_weight=0.0, velocity_bound_weight=0.0, tilt_weight=0.0,
    thrust_norm_weight=0.0,
)


def _arrays(rng, batch, n_obs=3, goal_sd=3.0):
    obs = np.concatenate(
        [rng.normal(0, 4, (batch, n_obs, 3)), rng.uniform(0.3, 1.2, (batch, n_obs, 1))],
        axis=-1,
    ).astype(np.float32)
    p0 = rng.normal(0, 2, (batch, 3)).astype(np.float32) + np.float32([0, 0, 5])
    v0 = rng.normal(0, 1, (batch, 3)).astype(np.float32)
    goal = rng.normal(0, goal_sd, (batch, 3)).astype(np.float32) + np.float32([0, 0, 5])
    return p0, v0, goal, obs


def _plain(config, prob, u0, use_obstacles=True):
    return cuda_mpc.solve_thrusts_plain(config, prob, u0, use_obstacles)


def _jax():
    import jax.numpy as jnp

    from dart_planner_tpu.ops import pallas_mpc
    from dart_planner_tpu.planning import se3_mpc as J

    return J, pallas_mpc, jnp


def _both(config, arrays, use_obstacles=True):
    """The same problem in both packages, the JAX cold start as the shared
    initial thrust plan."""
    J, _, _ = _jax()
    p0, v0, goal, obs = arrays
    jcfg = J.SE3MPCConfig(**config._asdict())
    obs = obs if use_obstacles else None
    pj = J.make_problem(p0, v0, goal, obstacles=obs, config=jcfg)
    pt = T.make_problem(p0, v0, goal, obstacles=obs, config=config)
    u0 = np.asarray(J.initialize_thrusts(jcfg, pj), np.float32)
    return jcfg, pj, pt, u0


def test_plain_convex_parity_with_fused_and_xla():
    J, pallas_mpc, _ = _jax()
    rng = np.random.default_rng(0)
    jcfg, pj, pt, u0 = _both(CONVEX, _arrays(rng, 4), use_obstacles=False)
    u, imp, pos, vel, cost = _plain(CONVEX, pt, torch.tensor(u0), False)
    uf, impf, posf, velf, costf = pallas_mpc.solve_thrusts_fused(
        jcfg, pj, u0, use_obstacles=False, block_b=8, interpret=True
    )
    rx = J.solve(jcfg, pj, u0, method="xla", use_obstacles=False)
    for ref_u, ref_c in ((uf, costf), (rx.thrusts, rx.cost)):
        np.testing.assert_allclose(u.numpy(), np.asarray(ref_u, np.float32), atol=2e-3)
        np.testing.assert_allclose(cost.numpy(), np.asarray(ref_c, np.float32), rtol=1e-5)
    np.testing.assert_allclose(pos.numpy(), np.asarray(posf), atol=2e-3)
    np.testing.assert_allclose(vel.numpy(), np.asarray(velf), atol=2e-3)


def test_plain_obstacle_aggregate_quality():
    J, pallas_mpc, _ = _jax()
    rng = np.random.default_rng(1)
    jcfg, pj, pt, u0 = _both(CFG, _arrays(rng, 16))
    u, _, _, _, cost = _plain(CFG, pt, torch.tensor(u0))
    cp = cost.numpy()
    c0 = np.asarray(J._finalize(jcfg, pj, u0).cost, np.float32)
    assert np.all(cp <= c0 + 1e-3)  # every scenario descends
    uf, _, _, _, costf = pallas_mpc.solve_thrusts_fused(
        jcfg, pj, u0, block_b=8, interpret=True
    )
    rx = J.solve(jcfg, pj, u0, method="xla")
    for ref_u, ref_c in ((uf, costf), (rx.thrusts, rx.cost)):
        cr = np.asarray(ref_c, np.float32)
        assert np.mean(cp) <= np.mean(cr) * 1.05
        assert np.mean(cr) <= np.mean(cp) * 1.05
        close = np.abs(u.numpy() - np.asarray(ref_u, np.float32)) < 0.05
        assert close.all(axis=(-1, -2)).mean() >= 0.5


def test_plain_full_curvature_with_padding_rows():
    """N=12: 3N % 8 != 0, so the TPU kernel's layout had padding rows; the
    stage-2 Jacobi clamp needs its floor there. The plain loop must reach
    the XLA path's costs (rtol 1e-4) and convergence flags."""
    J, _, _ = _jax()
    config = T.SE3MPCConfig(
        prediction_horizon=12, max_iterations=10, gn_warmup_iterations=4,
        cg_iterations=10,
    )
    rng = np.random.default_rng(0)
    jcfg, pj, pt, u0 = _both(config, _arrays(rng, 8))
    rx = J.solve(jcfg._replace(tail_iterations=0), pj, u0, method="xla")
    rt = T.solve(config._replace(tail_iterations=0), pt, torch.tensor(u0), method="torch")
    np.testing.assert_allclose(
        rt.cost.numpy(), np.asarray(rx.cost, np.float32), rtol=1e-4
    )
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rx.converged))


def test_plain_uniform_vcap_matches_static():
    """Problem.v_cap == max_velocity reproduces the static cap exactly."""
    rng = np.random.default_rng(7)
    p0, v0, goal, obs = _arrays(rng, 16)
    prob = T.make_problem(p0, v0, goal, obstacles=obs, config=CFG)
    u0 = T.initialize_thrusts(CFG, prob)
    vcap = torch.full((16,), CFG.max_velocity)
    r0 = _plain(CFG, prob, u0)
    r1 = _plain(CFG, prob._replace(v_cap=vcap), u0)
    for a, b in zip(r0, r1):
        assert torch.equal(a, b)


def test_fused_wrapper_on_cpu_runs_plain_and_counts_nothing():
    rng = np.random.default_rng(2)
    p0, v0, goal, obs = _arrays(rng, 3)
    prob = T.make_problem(p0, v0, goal, obstacles=obs, config=CFG)
    u0 = T.initialize_thrusts(CFG, prob)
    before = cuda_mpc.LAUNCHES
    fused = cuda_mpc.solve_thrusts_fused(CFG, prob, u0)
    plain = _plain(CFG, prob, u0)
    assert cuda_mpc.LAUNCHES == before
    for a, b in zip(fused, plain):
        assert torch.equal(a, b)


@pytest.mark.parametrize("N", [8, 12, 20, 40])
def test_kernel_constant_block_layout(N):
    """Apply the kernel's constant block as the kernel does (lane k reads
    ``M[j * LD + k]`` against a staged vector x_j) and recover the rollout
    maps, the quadratic Hessian and their transposes."""
    config = T.SE3MPCConfig(prediction_horizon=N)
    LD = cuda_mpc.lane_stride(N)
    c = cuda_mpc.constants_host(config)
    assert c.numel() == 5 * N * LD + 4 * LD
    blocks = c[: 5 * N * LD].reshape(5, N, LD)
    tv, spg, svg, dq = c[5 * N * LD:].reshape(4, LD)
    x = torch.randn(N, generator=torch.Generator().manual_seed(N))

    def apply(M):  # y[k] = sum_j M[j * LD + k] x[j]
        return (M * x[:, None]).sum(0)

    S_p, S_v, t = dynamics.rollout_matrices(N, config.dt)
    Sp = torch.as_tensor(S_p, dtype=torch.float32) / config.mass
    Sv = torch.as_tensor(S_v, dtype=torch.float32) / config.mass
    from dart_planner_tpu_torch.ops import costs

    H = torch.as_tensor(
        costs.quadratic_hessian(N, config.dt, config.mass, config.gravity,
                                config.weights), dtype=torch.float32,
    )
    expect = [H @ x, Sp @ x, Sv @ x, Sp.T @ x, Sv.T @ x]
    for blk, e in zip(blocks, expect):
        y = apply(blk)
        # float32 sums in another order: errors scale with the largest term
        scale = float((blk[:, :N].abs() * x.abs()[:, None]).sum(0).max())
        torch.testing.assert_close(y[:N], e, rtol=0, atol=1e-6 * scale)
        assert torch.all(y[N:] == 0)  # idle lanes read exact zeros
    torch.testing.assert_close(tv[:N], torch.as_tensor(t, dtype=torch.float32))
    torch.testing.assert_close(spg[:N], torch.as_tensor(S_p.sum(1), dtype=torch.float32))
    torch.testing.assert_close(svg[:N], torch.as_tensor(S_v.sum(1), dtype=torch.float32))
    torch.testing.assert_close(dq[:N], torch.diagonal(H))
    assert torch.all(dq[N:] == 0) and torch.all(tv[N:] == 0)


def test_kernel_params_follow_config():
    p = cuda_mpc._params(T.SE3MPCConfig(), B=5, K=8, use_obstacles=True)
    assert (p.n_gn, p.n_full, p.cg_iters, p.n_alpha) == (6, 6, 10, 6)
    assert list(p.alphas)[:6] == pytest.approx([1.0, 0.5, 0.25, 0.1, 0.03, 0.01])
    assert (p.use_ground, p.use_vel_hinge, p.use_tilt, p.use_tnorm) == (1, 1, 1, 1)
    tail = T.SE3MPCConfig()._replace(
        max_iterations=8, gn_warmup_iterations=0, cg_iterations=25,
        line_search_alphas=(1.0, 0.5, 0.25, 0.05),
    )
    q = cuda_mpc._params(tail, B=1, K=8, use_obstacles=False)
    assert (q.n_gn, q.n_full, q.cg_iters, q.n_alpha, q.use_obstacles) == (0, 8, 25, 4, 0)
    assert cuda_mpc.stage_counts(CFG._replace(newton_full_curvature=False)) == (4, 0)
    with pytest.raises(ValueError):
        cuda_mpc._params(CFG._replace(line_search_alphas=(1.0,) * 9), 1, 8, True)


# --- on a CUDA device: the hand-written kernel against the plain loop ------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _gpu_problem(config, batch, seed, device, n_obs=3):
    rng = np.random.default_rng(seed)
    p0, v0, goal, obs = _arrays(rng, batch, n_obs=n_obs, goal_sd=5.0)
    return T.make_problem(p0, v0, goal, obstacles=obs, config=config, device=device)


def _kernel_vs_plain(config, prob, use_obstacles=True):
    u0 = T.initialize_thrusts(config, prob)
    before = cuda_mpc.LAUNCHES
    k = cuda_mpc.solve_thrusts_fused(config, prob, u0, use_obstacles)
    torch.cuda.synchronize()
    assert cuda_mpc.LAUNCHES == before + 1
    p = cuda_mpc.solve_thrusts_plain(config, prob, u0, use_obstacles)
    return u0, [x.cpu() for x in k], [x.cpu() for x in p]


@pytest.mark.cuda
@pytest.mark.parametrize("N", [8, 12, 20, 40])
@pytest.mark.parametrize("stage", ["gauss_newton", "full_curvature"])
def test_cuda_kernel_one_round_matches_plain(cuda_device, N, stage):
    """One Newton round at CG-2 with every hinge and the obstacles on: a
    path float32 rounding cannot branch, so thrusts agree to 2e-3 and costs
    to 1e-5 relative. Covers one and two horizon steps per lane (N=40) and
    idle lanes (N=12, 20) in both curvature modes."""
    config = T.SE3MPCConfig(
        prediction_horizon=N, max_iterations=1, cg_iterations=2,
        tail_iterations=0,
        gn_warmup_iterations=1 if stage == "gauss_newton" else 0,
    )
    prob = _gpu_problem(config, 256, N, cuda_device, n_obs=4)
    _, k, p = _kernel_vs_plain(config, prob)
    torch.testing.assert_close(k[0], p[0], rtol=0, atol=2e-3)
    torch.testing.assert_close(k[2], p[2], rtol=0, atol=2e-3)
    torch.testing.assert_close(k[3], p[3], rtol=0, atol=2e-3)
    # the kernel's own cost pass, on its own thrusts: 1e-5 relative
    from dart_planner_tpu_torch.ops import costs

    gvec = torch.tensor([0.0, 0.0, -config.gravity], device=cuda_device)
    ku = k[0].to(cuda_device)
    c_own = costs.condensed_cost(
        ku, prob, config.weights, config.dt, config.mass, gvec
    ).cpu()
    torch.testing.assert_close(k[4], c_own, rtol=1e-5, atol=0)
    # against the plain loop's iterate: thrusts that differ by ~1e-4 N move
    # positions over N steps, and the 1e3-1e5 hinge weights turn that into
    # up to ~2e-5 relative cost at N=40 (the plain loop on the CPU vs the
    # GPU differs as much), hence 1e-4
    torch.testing.assert_close(k[4], p[4], rtol=1e-4, atol=0)


@pytest.mark.cuda
def test_cuda_kernel_convex_parity(cuda_device):
    """The JAX package's convex regime (N=8, 4 rounds at CG-10, as in
    tests/test_pallas_mpc.py). Through the first three rounds thrusts agree
    to 2e-3 on every scenario. After round 4 costs agree to 1e-5 relative
    everywhere, and thrusts to 2e-3 on nearly every scenario: by then most
    scenarios sit on the optimum's plateau, where the best candidate can tie
    the current iterate in float32 cost. On a tie the two line-search rules
    part: the kernel keeps the iterate, the plain loop's argmin takes the
    candidate. Measured on an H100 at this seed: scenario 11 in round 4,
    where the plain loop's candidate is 2e-4 lower in float64 (0.05 ulp of
    the float32 cost) and 6.9e-3 N from the kept iterate. The plain loop on
    the GPU and on the CPU part there by 2.1e-2 N. Such scenarios are held
    to 0.05."""
    rng = np.random.default_rng(0)
    p0, v0, goal, _ = _arrays(rng, 16)
    prob = T.make_problem(p0, v0, goal, config=CONVEX, device=cuda_device)
    _, k3, p3 = _kernel_vs_plain(
        CONVEX._replace(max_iterations=3), prob, use_obstacles=False
    )
    torch.testing.assert_close(k3[0], p3[0], rtol=0, atol=2e-3)
    _, k, p = _kernel_vs_plain(CONVEX, prob, use_obstacles=False)
    torch.testing.assert_close(k[4], p[4], rtol=1e-5, atol=0)
    du = (k[0] - p[0]).abs().amax((-1, -2))
    assert float((du <= 2e-3).float().mean()) >= 0.9
    assert float(du.max()) <= 0.05


@pytest.mark.cuda
@pytest.mark.parametrize(
    "N,rounds,cg,close_min",
    [(8, 12, 10, 0.5), (12, 12, 10, 0.5), (20, 12, 10, 0.5), (40, 3, 8, None)],
)
def test_cuda_kernel_obstacles_aggregate(cuda_device, N, rounds, cg, close_min):
    """Full config (all hinges, GN then full curvature): the aggregate
    contract. N=12 and N=20 keep idle lanes through stage 2. N=40 runs the
    JAX package's own large-horizon case (16 live spheres, 3 rounds at
    CG-8) and contract (descent, mean cost within 5%): at 12 rounds the
    plain loop alone, on the GPU and on the CPU, already disagrees on most
    scenarios there."""
    live = 16 if N == 40 else 4
    config = T.SE3MPCConfig(
        prediction_horizon=N, max_iterations=rounds, cg_iterations=cg,
        tail_iterations=0, max_obstacles=max(8, live),
    )
    prob = _gpu_problem(config, 256, 100 + N, cuda_device, n_obs=live)
    u0, k, p = _kernel_vs_plain(config, prob)
    for x in k:
        assert torch.isfinite(x).all()
    gvec = torch.tensor([0.0, 0.0, -config.gravity], device=cuda_device)
    from dart_planner_tpu_torch.ops import costs

    c0 = costs.condensed_cost(
        u0, prob, config.weights, config.dt, config.mass, gvec
    ).cpu()
    assert torch.all(k[4] <= c0 + 1e-3)
    mk, mp = float(k[4].mean()), float(p[4].mean())
    assert mk <= 1.05 * mp and mp <= 1.05 * mk
    lb, ub = config.thrust_bounds()
    assert torch.all(k[0] >= lb - 1e-5) and torch.all(k[0] <= ub + 1e-5)
    if close_min is not None:
        close = ((k[0] - p[0]).abs() < 0.05).all(-1).all(-1).float().mean()
        assert close >= close_min
        conv_k = (k[1] <= config.ftol).float().mean()
        conv_p = (p[1] <= config.ftol).float().mean()
        assert abs(float(conv_k - conv_p)) <= 0.05


@pytest.mark.cuda
def test_cuda_kernel_uniform_vcap_is_static_and_cap_binds(cuda_device):
    config = CFG._replace(prediction_horizon=20)
    prob = _gpu_problem(config, 64, 5, cuda_device)
    u0 = T.initialize_thrusts(config, prob)
    r0 = cuda_mpc.solve_thrusts_fused(config, prob, u0)
    full = torch.full((64,), config.max_velocity, device=cuda_device)
    r1 = cuda_mpc.solve_thrusts_fused(config, prob._replace(v_cap=full), u0)
    for a, b in zip(r0, r1):
        assert torch.equal(a, b)
    cap = torch.full((64,), 2.0, device=cuda_device)
    r2 = cuda_mpc.solve_thrusts_fused(config, prob._replace(v_cap=cap), u0)
    assert float(r2[3].abs().amax()) < float(r0[3].abs().amax())


@pytest.mark.cuda
def test_cuda_kernel_shapes_and_shared_fields(cuda_device):
    """Unbatched (N, 3) in gives (N, 3) out; shared goal/obstacles broadcast
    like their per-scenario copies; a (2, 3) batch keeps its shape."""
    config = CFG
    N = config.prediction_horizon
    prob = _gpu_problem(config, 6, 9, cuda_device)
    one = T.costs.Problem(*[None if x is None else x[0] for x in prob])
    u1 = T.initialize_thrusts(config, one)
    out = cuda_mpc.solve_thrusts_fused(config, one, u1)
    assert out[0].shape == (N, 3) and out[4].shape == ()
    shared = prob._replace(goal=prob.goal[0], obstacles=prob.obstacles[0],
                           obstacle_mask=prob.obstacle_mask[0])
    copied = prob._replace(
        goal=prob.goal[:1].expand(6, 3), obstacles=prob.obstacles[:1].expand(6, -1, -1),
        obstacle_mask=prob.obstacle_mask[:1].expand(6, -1),
    )
    u0 = T.initialize_thrusts(config, copied)
    a = cuda_mpc.solve_thrusts_fused(config, shared, u0)
    b = cuda_mpc.solve_thrusts_fused(config, copied, u0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    grid = T.costs.Problem(*[None if x is None else x.reshape((2, 3) + x.shape[1:])
                             for x in prob])
    ug = T.initialize_thrusts(config, grid)
    g = cuda_mpc.solve_thrusts_fused(config, grid, ug)
    assert g[0].shape == (2, 3, N, 3) and g[1].shape == (2, 3)
    flat = cuda_mpc.solve_thrusts_fused(config, prob, ug.reshape(6, N, 3))
    assert torch.equal(g[0].reshape(6, N, 3), flat[0])


@pytest.mark.cuda
def test_cuda_two_phase_solve_launches_twice(cuda_device):
    config = T.SE3MPCConfig(prediction_horizon=20)
    prob = _gpu_problem(config, 128, 11, cuda_device, n_obs=4)
    before = cuda_mpc.LAUNCHES
    res = T.solve(config, prob)
    torch.cuda.synchronize()
    assert cuda_mpc.LAUNCHES == before + 2
    ref = T.solve(config, prob, method="torch")
    assert torch.isfinite(res.cost).all()
    assert float(res.cost.mean()) <= 1.05 * float(ref.cost.mean())
    assert math.isclose(
        float(res.converged.float().mean()), float(ref.converged.float().mean()),
        abs_tol=0.1,
    )


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    prob = _gpu_problem(CFG, 4, 3, cuda_device)
    u0 = T.initialize_thrusts(CFG, prob)
    with pytest.raises(TypeError):
        cuda_mpc.solve_thrusts_fused(CFG, prob, u0.double())
    with pytest.raises(ValueError):
        cuda_mpc.solve_thrusts_fused(CFG, prob._replace(p0=prob.p0.cpu()), u0)
    long = CFG._replace(prediction_horizon=cuda_mpc.MAX_HORIZON + 1)
    with pytest.raises(ValueError):
        cuda_mpc.solve_thrusts_fused(
            long, prob, torch.zeros(4, long.prediction_horizon, 3, device=cuda_device)
        )
    with pytest.raises(ValueError):
        cuda_mpc.solve_thrusts_fused(CFG, prob, u0[:, :-1])
