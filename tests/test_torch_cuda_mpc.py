"""The port's solver kernel module (dart_planner_tpu_torch/ops/cuda_mpc.py).

On the CPU: the plain twin ``se3_mpc.solve_thrusts_plain`` is held against the JAX
package's fused Pallas kernel (interpret mode) and its XLA path on the same
numpy inputs; the kernel's constant block is checked by applying it the way
the kernel does, at one to eight horizon steps a lane and with any count of
line-search alphas. On a CUDA device (tests marked ``cuda``): the hand-written
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

import ctypes
import math
import re

import numpy as np
import pytest
import torch

from dart_planner_tpu_torch.ops import _build, cuda_mpc, dynamics
from dart_planner_tpu_torch.planning import se3_mpc as T
from _emulated_b1 import check_live_order, check_segment_isolation, mixed_spheres

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
    return T.solve_thrusts_plain(config, prob, u0, use_obstacles)


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
    pt = T.make_problem(p0, v0, goal, obstacles=obs, config=config, device="cpu")
    u0 = np.asarray(J.initialize_thrusts(jcfg, pj), np.float32)
    return jcfg, pj, pt, u0


def test_plain_convex_parity_with_fused_and_xla():
    J, pallas_mpc, _ = _jax()
    rng = np.random.default_rng(0)
    jcfg, pj, pt, u0 = _both(CONVEX, _arrays(rng, 4), use_obstacles=False)
    u, imp, pos, vel, cost, _ = _plain(CONVEX, pt, torch.tensor(u0), False)
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
    u, _, _, _, cost, _ = _plain(CFG, pt, torch.tensor(u0))
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
    prob = T.make_problem(p0, v0, goal, obstacles=obs, config=CFG, device="cpu")
    u0 = T.initialize_thrusts(CFG, prob)
    vcap = torch.full((16,), CFG.max_velocity)
    r0 = _plain(CFG, prob, u0)
    r1 = _plain(CFG, prob._replace(v_cap=vcap), u0)
    for a, b in zip(r0[:5], r1[:5]):
        assert torch.equal(a, b)


def test_fused_wrapper_on_cpu_runs_plain_and_counts_nothing():
    """The wrapper launches the kernel or raises: on CPU tensors it refuses,
    naming the plain twin, and counts no launch (``LAUNCHES`` and
    ``b1_launches`` stay)."""
    from dart_planner_tpu_torch.common.metrics import get_metrics

    rng = np.random.default_rng(2)
    p0, v0, goal, obs = _arrays(rng, 3)
    prob = T.make_problem(p0, v0, goal, obstacles=obs, config=CFG, device="cpu")
    u0 = T.initialize_thrusts(CFG, prob)
    before = cuda_mpc.LAUNCHES, get_metrics().series("b1_launches")
    with pytest.raises(ValueError, match="solve_thrusts_plain"):
        cuda_mpc.solve_thrusts_fused(CFG, prob, u0)
    assert (cuda_mpc.LAUNCHES, get_metrics().series("b1_launches")) == before


@pytest.mark.parametrize("N", [8, 12, 20, 40, 65, 96, 97, 128, 129, 160, 256])
def test_kernel_constant_block_layout(N):
    """The kernel's constant block is two step vectors (t, diag H), each 32
    floats a horizon step a lane and zero past N, then the line search's
    alphas. Applied as the kernel applies them, beside the structured maps
    over the accelerations, they reproduce ``rollout_linear``. N = 65, 96,
    97 and 128 are the first and last horizons of three and four steps a
    lane; 129, 160 and 256 five and eight, where the kernel reads the step
    count at run time."""
    from dart_planner_tpu_torch.ops import costs

    config = T.SE3MPCConfig(prediction_horizon=N)
    LD = cuda_mpc.lane_stride(N)
    assert LD == 32 * math.ceil(N / 32) and N <= LD < N + 32
    c = cuda_mpc.constants_host(config)
    n_alpha = len(config.line_search_alphas)
    assert c.numel() == 2 * LD + n_alpha and c.dtype == torch.float32
    torch.testing.assert_close(
        c[2 * LD:], torch.tensor(config.line_search_alphas, dtype=torch.float32), rtol=0, atol=0
    )
    tv, dq = c[: 2 * LD].reshape(2, LD)
    _, _, t = dynamics.rollout_matrices(N, config.dt)
    H = costs.quadratic_hessian(N, config.dt, config.mass, config.gravity, config.weights)
    for got, want in ((tv, t), (dq, np.diagonal(H))):
        torch.testing.assert_close(got[:N], torch.tensor(np.array(want), dtype=torch.float32))
        assert torch.all(got[N:] == 0)  # idle lanes read exact zeros
    gen = torch.Generator().manual_seed(N)
    u = 15.0 * torch.rand(2, N, 3, generator=gen)
    p0, v0 = torch.randn(2, 3, generator=gen), torch.randn(2, 3, generator=gen)
    g = torch.tensor([0.0, 0.0, -config.gravity])
    a = u / config.mass + g
    pos = p0[:, None] + tv[:N, None] * v0[:, None] + dynamics.apply_structured("S_p", a, config.dt)
    vel = v0[:, None] + dynamics.apply_structured("S_v", a, config.dt)
    rp, rv, _ = dynamics.rollout_linear(u, p0, v0, config.dt, config.mass, g)
    # float32 sums in another order: 1e-5 absolute up to two steps a lane;
    # past 64 steps these random thrusts carry the positions to 110-430 m
    # (ulp 8e-6-3e-5 m; measured 5.8e-7 relative), so there 2e-6 relative
    rtol = 0 if N <= 64 else 2e-6
    torch.testing.assert_close(pos, rp, rtol=rtol, atol=1e-5)
    torch.testing.assert_close(vel, rv, rtol=rtol, atol=1e-5)


def test_kernel_params_follow_config():
    config = T.SE3MPCConfig()
    p = cuda_mpc._params(config, B=5, K=8, use_obstacles=True)
    assert (p.n_gn, p.n_full, p.cg_iters, p.n_alpha) == (6, 6, 10, 6)
    assert cuda_mpc.constants_host(config)[-6:].tolist() == pytest.approx(
        [1.0, 0.5, 0.25, 0.1, 0.03, 0.01]
    )
    assert (p.use_ground, p.use_vel_hinge, p.use_tilt, p.use_tnorm) == (1, 1, 1, 1)
    assert p.dt == pytest.approx(0.1)
    # 1/m split in two floats: the float32 part and what its rounding took off
    assert float(np.float32(p.inv_m)) + p.inv_m_lo == pytest.approx(1.0 / config.mass, abs=1e-15)
    assert p.inv_m_lo != 0.0
    tail = T.SE3MPCConfig()._replace(
        max_iterations=8, gn_warmup_iterations=0, cg_iterations=25,
        line_search_alphas=(1.0, 0.5, 0.25, 0.05),
    )
    q = cuda_mpc._params(tail, B=1, K=8, use_obstacles=False)
    assert (q.n_gn, q.n_full, q.cg_iters, q.n_alpha, q.use_obstacles) == (0, 8, 25, 4, 0)
    assert cuda_mpc.stage_counts(CFG._replace(newton_full_curvature=False)) == (4, 0)
    # any count of alphas: they travel in the constant block
    assert cuda_mpc._params(CFG._replace(line_search_alphas=(1.0,) * 9), 1, 8, True).n_alpha == 9


# ascending, so that the full step and its halves are among the last four
TWELVE_ALPHAS = (0.005, 0.01, 0.02, 0.03, 0.06, 0.1, 0.18, 0.25, 0.35, 0.5, 0.7, 1.0)


@pytest.mark.parametrize("N", [20, 100])
def test_kernel_takes_twelve_alphas(N):
    """More alphas than the 8 the kernel once held: ``_params`` counts them
    and the constant block carries them, in order, after the two step
    vectors."""
    config = T.SE3MPCConfig(prediction_horizon=N, line_search_alphas=TWELVE_ALPHAS)
    assert cuda_mpc._params(config, B=3, K=8, use_obstacles=True).n_alpha == 12
    c = cuda_mpc.constants_host(config)
    LD = cuda_mpc.lane_stride(N)
    assert c.numel() == 2 * LD + 12
    assert c[2 * LD:].tolist() == pytest.approx(list(TWELVE_ALPHAS))


def test_fused_wrapper_on_cpu_returns_the_plain_norm():
    """The plain twin returns the wrapper's record: with ``with_grad`` it
    carries the dense projected-gradient norm of its thrusts, and its other
    fields equal those without it, whose norm is ``None``."""
    rng = np.random.default_rng(4)
    p0, v0, goal, obs = _arrays(rng, 3)
    prob = T.make_problem(p0, v0, goal, obstacles=obs, config=CFG, device="cpu")
    u0 = T.initialize_thrusts(CFG, prob)
    with_norm = T.solve_thrusts_plain(CFG, prob, u0, with_grad=True)
    plain = _plain(CFG, prob, u0)
    assert isinstance(with_norm, cuda_mpc.ThrustSolve) and plain.grad_norm is None
    for a, b in zip(with_norm[:5], plain[:5]):
        assert torch.equal(a, b)
    assert torch.equal(with_norm.grad_norm,
                       T.projected_grad_norm(CFG, prob, with_norm.thrusts))


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
    p = T.solve_thrusts_plain(config, prob, u0, use_obstacles)
    return u0, [x.cpu() for x in k[:5]], [x.cpu() for x in p[:5]]


def _packed_copies(config, prob, u0, p, copies=17):
    """The packed arm on the first 255 scenarios of a batch, repeated
    ``copies`` times in one launch (4335 scenarios: past one wave of one
    scenario a warp on a card of up to 270 SMs; 255 is odd, so each scenario
    sits in every segment of a warp, and the last warp has a segment past
    the batch). Every copy's outputs are the same bit for bit; returns those
    scenarios' problem, cold start, the packed outputs once and the plain
    ones ``p``."""
    idx = torch.arange(255).repeat(copies).to(u0.device)
    tiled = T.costs.Problem(*[None if x is None else x[idx] for x in prob])
    params = cuda_mpc._params(config, len(idx), prob.obstacles.shape[-2], True)
    assert cuda_mpc._library().mpc_scenarios_per_warp(ctypes.byref(params)) == 4
    k = cuda_mpc.solve_thrusts_fused(config, tiled, u0[idx])
    torch.cuda.synchronize()
    k = [x.cpu().reshape((copies, 255) + x.shape[1:]) for x in k[:5]]
    for x in k:
        assert torch.equal(x, x[:1].expand_as(x))
    first = T.costs.Problem(*[None if x is None else x[:255] for x in prob])
    return first, u0[:255], [x[0] for x in k], [x[:255] for x in p]


@pytest.mark.cuda
@pytest.mark.parametrize("N", [8, 12, 20, 24, 25, 32, 40, 65, 80, 100, 128, 160, 256])
@pytest.mark.parametrize("stage", ["gauss_newton", "full_curvature"])
def test_cuda_kernel_one_round_matches_plain(cuda_device, N, stage):
    """One Newton round at CG-2 with every hinge and the obstacles on: a
    path float32 rounding cannot branch, so thrusts agree to 2e-3 and costs
    to 1e-5 relative. Covers one to four horizon steps per lane (N=40: two;
    65: the third slot's first step; 80; 100: four; 128: a full fourth
    slot), five and eight (160, 256: the instantiation that reads the step
    count at run time) and idle lanes (N=12, 20) in both curvature modes;
    at N <= 32 the batch of 256 is within one wave of one scenario a warp,
    and the packed arm (four scenarios a warp: one to four steps a
    segment's lane at N = 8, 12, 20-24 and 25-32) is held to the same limits
    on the same scenarios, copied past that wave (``_packed_copies``). (On
    fresh draws at 4097 scenarios either arm parts from the plain loop
    beyond 2e-3 on about one in 4000, where CG's second step meets a 1e4
    times larger residual: PERF.md section 7.)"""
    config = T.SE3MPCConfig(
        prediction_horizon=N, max_iterations=1, cg_iterations=2,
        tail_iterations=0,
        gn_warmup_iterations=1 if stage == "gauss_newton" else 0,
    )
    prob = _gpu_problem(config, 256, N, cuda_device, n_obs=4)
    u0, k, p = _kernel_vs_plain(config, prob)
    cases = [(prob, u0, k, p)]
    if N <= 32:
        cases.append(_packed_copies(config, prob, u0, p))
    for prob, u0, k, p in cases:
        _one_round_limits(config, N, prob, u0, k, p)


def _one_round_limits(config, N, prob, u0, k, p):
    """test_cuda_kernel_one_round_matches_plain's limits on one launch."""
    torch.testing.assert_close(k[0], p[0], rtol=0, atol=2e-3)
    if N <= 64:
        torch.testing.assert_close(k[2], p[2], rtol=0, atol=2e-3)
        torch.testing.assert_close(k[3], p[3], rtol=0, atol=2e-3)
    else:
        # Past 64 steps the rollout maps carry a thrust difference to the
        # positions magnified by up to N^2 dt^2 / 2m (33 at N=100), so 2e-3
        # N of thrust allows centimetres (an H100 at N=100: 3.6e-3 m on one
        # scenario of 256, its thrusts within 2e-3). There the kernel's
        # positions and velocities are held to the exact (float64) rollout
        # of its own thrusts instead.
        pos, vel = _exact_rollout(config, prob, k[0])
        torch.testing.assert_close(k[2].double(), pos, rtol=0, atol=1e-4)
        torch.testing.assert_close(k[3].double(), vel, rtol=0, atol=1e-4)
    # The kernel's own cost pass against the exact (float64) cost of its own
    # thrusts: 1e-5 relative. The float64 reference, since past 64 steps the
    # plain loop's float32 cost on the card is itself further from it than
    # the kernel's (chip_smoke.py phase 18a prints both).
    ek = _exact_cost_cpu(config, prob, k[0])
    torch.testing.assert_close(k[4].double(), ek, rtol=1e-5, atol=0)
    # against the plain loop's iterate: thrusts that differ by ~1e-4 N move
    # positions over N steps, and the 1e3-1e5 hinge weights turn that into
    # up to ~2e-5 relative cost at N=40 (the plain loop on the CPU vs the
    # GPU differs as much), hence 1e-4, on the two iterates' exact costs.
    # Past 64 steps the same magnification lets thrusts within 2e-3 part the
    # costs by more (an H100 at N=100: 4.2e-4 on one scenario of 256), so
    # there the thrusts above are the iterate's check.
    if N <= 64:
        torch.testing.assert_close(ek, _exact_cost_cpu(config, prob, p[0]), rtol=1e-4, atol=0)
    # The smallest relative improvement, which decides the converged flags,
    # (cost(u0) - cost(u)) / (1 + |cost(u)|) of this round: to the plain
    # loop's within 1e-4 of 1 + |improvement|, as far as costs 1e-4
    # relative apart move it. Past 64 steps, to the exact improvement of the
    # kernel's own iterate, each of its two costs within 1e-4 relative (the
    # cost at the cold start, up to ~150x the round's, is not held to the
    # 1e-5 of the final cost above: an H100 at N=256, 1.27x that).
    if N <= 64:
        torch.testing.assert_close(k[1], p[1], rtol=1e-4, atol=1e-4)
    else:
        e0 = _exact_cost_cpu(config, prob, u0)
        exact = (e0 - ek) / (1.0 + ek.abs())
        lim = 1e-4 * (e0.abs() + ek.abs()) / (1.0 + ek.abs())
        assert bool(((k[1].double() - exact).abs() <= lim).all()), \
            float(((k[1].double() - exact).abs() / lim).max())


@pytest.mark.cuda
def test_cuda_packed_arm_scenario_is_alone_in_its_segment(cuda_device):
    """On the card, as in the emulation
    (``_emulated_b1.check_segment_isolation``): each scenario's outputs are
    the same bit for bit alone in its warp and beside three others, one of
    which breaks CG at its first step, in batches of 4097 (past one wave of
    one scenario a warp on a card of up to 256 SMs)."""
    def solve(config, prob, u0):
        out = cuda_mpc.solve_thrusts_fused(config, prob, u0)
        torch.cuda.synchronize()
        return out

    check_segment_isolation(solve, cuda_device, 4097)


@pytest.mark.cuda
def test_cuda_live_order_is_invisible_at_the_mc_size(cuda_device, monkeypatch):
    """The packed arm's order by live spheres on the card at the Monte-Carlo
    cell's size: 16,384 scenarios at N=20 with 11 sphere slots (the closed
    loop's 8 perceived and 3 sensed), 0 to 11 live in each, on the packed
    arm at the full phase-1 budget with the final norm: the outputs are the
    same bit for bit as the same launch in the order given, and a permuted
    batch's are the permuted outputs (``_emulated_b1.check_live_order``)."""
    config = T.SE3MPCConfig(max_obstacles=11, tail_iterations=0)
    params = cuda_mpc._params(config, 16384, 11, True)
    assert cuda_mpc._library().mpc_scenarios_per_warp(ctypes.byref(params)) == 4
    prob = mixed_spheres(config, 16384, 0, cuda_device)

    def solve(config, prob, u0):
        out = cuda_mpc.solve_thrusts_fused(config, prob, u0, with_grad=True)
        torch.cuda.synchronize()
        return out

    check_live_order(solve, config, prob, monkeypatch)


# ptxas' registers and spill bytes (stores, loads) of the one-scenario-a-warp
# arms, as built since the final norm's pass (PERF.md section 6): one to
# four steps a lane, and the run-time arm (S = 5)
OTHER_ARMS = {1: (123, 0, 0), 2: (190, 0, 0), 3: (167, 0, 0), 4: (217, 0, 0),
              5: (128, 16, 16)}


def _ptxas_arms(log):
    """{S: (registers, spill store bytes, spill load bytes)} of each
    mpc_solve_kernel<S> in an nvcc -Xptxas -v log, and under ("ordered", S)
    those of the packed arm's instantiations that take an order."""
    arms, S = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*mpc_solve_kernelILi(\d+)ELb([01])EE", line)
        if m:
            S = int(m.group(1)) if m.group(2) == "0" else ("ordered", int(m.group(1)))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and S is not None:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and S is not None:
            arms[S] = (int(m.group(1)),) + spill
            S = None
    return arms


@pytest.mark.cuda
def test_cuda_build_keeps_the_other_arms_and_packs_without_spills(cuda_device, tmp_path):
    """Kernel B1 built alone with the package's nvcc flags: the
    one-scenario-a-warp arms keep their registers and spills; the packed arm's four
    instantiations (S = 9-12: one to four steps a segment's lane) spill
    nothing, three steps a lane fits 168 registers, and so do their four
    that take an order by live spheres; the occupancy
    calculator keeps 12 warps (48 scenarios) an SM at N=20, K=8 past one
    wave of one scenario a warp, that arm's 16 up to it, and the S=4 arm's
    8 at N=100."""
    sources = [_build.SRC_DIR / "mpc_solve.cu", _build.SRC_DIR / "mpc_solve_steps.cu"]
    arms = _ptxas_arms(_build.compile_library(sources, tmp_path / "libb1.so"))
    assert {S: arms.get(S) for S in OTHER_ARMS} == OTHER_ARMS, arms
    for ordered in (False, True):
        packed = {S: arms[("ordered", S) if ordered else S] for S in (9, 10, 11, 12)}
        assert all(v[1:] == (0, 0) for v in packed.values()), packed
        assert packed[11][0] <= 168, packed
    assert len(arms) == len(OTHER_ARMS) + 8, arms

    def arm(N, B):
        params = ctypes.byref(cuda_mpc._params(T.SE3MPCConfig(prediction_horizon=N), B, 8, True))
        lib = cuda_mpc._library()
        return lib.mpc_scenarios_per_warp(params), lib.mpc_resident_warps(params)

    # (scenarios a warp, resident warps an SM): the packed arm past one wave
    # of one scenario a warp (16 warps on each SM), that arm up to it
    wave = 16 * torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert arm(20, 131072) == arm(20, wave + 1) == (4, 12)
    assert arm(20, 1) == arm(20, wave) == (1, 16)
    assert arm(100, 131072) == (1, 8) and arm(33, 131072)[0] == 1


def _exact_cost_cpu(config, prob, u):
    """``cuda_mpc.exact_cost`` on the CPU (the kernel's outputs are copied
    there by ``_kernel_vs_plain``)."""
    prob = T.costs.Problem(*[None if x is None else x.cpu() for x in prob])
    return cuda_mpc.exact_cost(config, prob, u.cpu())


def _exact_rollout(config, prob, u):
    """Positions and velocities of thrusts ``u`` in float64 from the float32
    inputs, on the CPU."""
    g = torch.tensor([0.0, 0.0, -config.gravity], dtype=torch.float32).double()
    pos, vel, _ = dynamics.rollout_linear(u.cpu().double(), prob.p0.cpu().double(),
                                          prob.v0.cpu().double(), config.dt, config.mass, g)
    return pos, vel


@pytest.mark.cuda
@pytest.mark.parametrize("N", [20, 100])
def test_cuda_kernel_twelve_alphas_one_round(cuda_device, N):
    """The line search over 12 alphas, more than the kernel once held: one
    Newton round at CG-2 from the cold start against the plain loop, which
    takes the same alphas (thrusts, positions and velocities 2e-3, the
    costs as the one-round test checks them)."""
    config = T.SE3MPCConfig(
        prediction_horizon=N, max_iterations=1, cg_iterations=2, tail_iterations=0,
        gn_warmup_iterations=1, line_search_alphas=TWELVE_ALPHAS,
    )
    prob = _gpu_problem(config, 256, 200 + N, cuda_device, n_obs=4)
    _, k, p = _kernel_vs_plain(config, prob)
    for i in (0, 2, 3):
        torch.testing.assert_close(k[i], p[i], rtol=0, atol=2e-3)
    ek = _exact_cost_cpu(config, prob, k[0])
    torch.testing.assert_close(k[4].double(), ek, rtol=1e-5, atol=0)
    torch.testing.assert_close(ek, _exact_cost_cpu(config, prob, p[0]), rtol=1e-4, atol=0)
    # the candidates past the eighth alpha are tried: dropping them (the
    # largest four) changes the step in some scenario
    _, k8, _ = _kernel_vs_plain(config._replace(line_search_alphas=TWELVE_ALPHAS[:8]), prob)
    assert not torch.equal(k8[0], k[0])


def _hinge_activity(config, prob, u):
    """Scenarios in which each hinge term of the cost is active at ``u``."""
    from dart_planner_tpu_torch.ops import costs

    w = config.weights
    gvec = torch.tensor([0.0, 0.0, -config.gravity], device=u.device)
    pos, vel, _ = dynamics.rollout_linear(u, prob.p0, prob.v0, config.dt, config.mass, gvec)
    lat = torch.linalg.vector_norm(u[..., :2], dim=-1)
    terms = {
        "obstacle": costs.obstacle_penalty(pos, prob.obstacles, prob.obstacle_mask) > 0,
        "ground": (pos[..., 2] < w.ground_altitude).any(-1),
        "velocity": (vel.abs() > costs.effective_vmax(prob, w)).any(-1).any(-1),
        "tilt": (lat > w.tan_max_tilt * u[..., 2]).any(-1),
        "thrust_norm": (torch.linalg.vector_norm(u, dim=-1) > w.max_thrust_norm).any(-1),
    }
    return {name: int(active.sum()) for name, active in terms.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["gauss_newton", "full_curvature"])
def test_cuda_kernel_two_steps_per_lane_every_hinge(cuda_device, stage):
    """N=40: each lane holds two horizon steps, so every warp scan carries
    its first slot's total into the second. One Newton round at CG-2 from
    the cold start with every hinge active in some scenario (a per-scenario
    v_cap of 1.5 m/s wakes the velocity envelope): thrusts, positions and
    velocities within 2e-3 of the plain loop, the cost within 1e-5 of the
    cost of the kernel's own thrusts."""
    from dart_planner_tpu_torch.ops import costs

    config = T.SE3MPCConfig(
        prediction_horizon=40, max_iterations=1, cg_iterations=2, tail_iterations=0,
        gn_warmup_iterations=1 if stage == "gauss_newton" else 0,
    )
    prob = _gpu_problem(config, 256, 40, cuda_device, n_obs=4)
    prob = prob._replace(v_cap=torch.full((256,), 1.5, device=cuda_device))
    u0 = T.initialize_thrusts(config, prob)
    act = _hinge_activity(config, prob, u0)
    assert all(n > 0 for n in act.values()), act
    _, k, p = _kernel_vs_plain(config, prob)
    for i in (0, 2, 3):
        torch.testing.assert_close(k[i], p[i], rtol=0, atol=2e-3)
    gvec = torch.tensor([0.0, 0.0, -config.gravity], device=cuda_device)
    c_own = costs.condensed_cost(
        k[0].to(cuda_device), prob, config.weights, config.dt, config.mass, gvec
    ).cpu()
    torch.testing.assert_close(k[4], c_own, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_cuda_kernel_convex_parity(cuda_device):
    """The JAX package's convex regime (N=8, 4 rounds at CG-10, as in
    tests/test_pallas_mpc.py). Through the first three rounds thrusts agree
    to 2e-3 on every scenario. After round 4 costs agree to 1e-5 relative
    everywhere, and thrusts to 2e-3 on nearly every scenario: by then most
    scenarios sit on the optimum's plateau, where the best candidate can tie
    the current iterate in float32 cost. On a tie the two line-search rules
    part: the kernel keeps the iterate, the plain loop's argmin takes the
    candidate. Measured on an H100 at this seed: scenario 11 in round 4
    and nowhere else. The kernel ends 2.1e-2 N from the plain loop there,
    its float32 cost one ulp below the plain loop's (33132.754 against
    33132.758); rounds 1-3 agree to 8.8e-4 N. The kernel that applied its
    maps as dense products parted at the same place by 6.9e-3 N, and the
    plain loop on the GPU and on the CPU part there by 2.1e-2 N. Such
    scenarios are held to 0.05."""
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
    [(8, 12, 10, 0.5), (12, 12, 10, 0.5), (20, 12, 10, 0.5), (40, 3, 8, None),
     (80, 3, 8, None)],
)
def test_cuda_kernel_obstacles_aggregate(cuda_device, N, rounds, cg, close_min):
    """Full config (all hinges, GN then full curvature): the aggregate
    contract. N=12 and N=20 keep idle lanes through stage 2. N=40 runs the
    JAX package's own large-horizon case (16 live spheres, 3 rounds at
    CG-8) and contract (descent, mean cost within 5%): at 12 rounds the
    plain loop alone, on the GPU and on the CPU, already disagrees on most
    scenarios there. N=80 (three steps a lane) runs the same case."""
    live = 16 if N >= 40 else 4
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
    for a, b in zip(r0[:5], r1[:5]):
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
    for x, y in zip(a[:5], b[:5]):
        assert torch.equal(x, y)
    grid = T.costs.Problem(*[None if x is None else x.reshape((2, 3) + x.shape[1:])
                             for x in prob])
    ug = T.initialize_thrusts(config, grid)
    g = cuda_mpc.solve_thrusts_fused(config, grid, ug)
    assert g[0].shape == (2, 3, N, 3) and g[1].shape == (2, 3)
    flat = cuda_mpc.solve_thrusts_fused(config, prob, ug.reshape(6, N, 3))
    assert torch.equal(g[0].reshape(6, N, 3), flat[0])


@pytest.mark.cuda
@pytest.mark.parametrize("N", [20, 160])
def test_cuda_two_phase_solve_launches_twice(cuda_device, N):
    """Two launches of B1 a two-phase solve, at the default horizon and past
    128 steps (five a lane)."""
    config = T.SE3MPCConfig(prediction_horizon=N)
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
def test_cuda_solve_takes_the_kernels_grad_norm(cuda_device, monkeypatch):
    """A warm two-phase ``solve()`` at B=4096 with spheres: phase 1's launch
    brings the projected-gradient norm; the solve's thrusts and costs equal
    those of the same solve with the norm withheld from the launch (then
    computed by the dense formula) bit for bit; and it still launches B1
    twice. Against the dense formula in float64 on the launch's thrusts,
    the kernel's norm is as close as the dense float32 one, within a factor
    of 4 at the median, the 90th and 99th percentiles and the largest
    error: both are float32 norms whose error is set by the float32 states
    times the hinge weights (the ground's is 5e4), not by the norm, so near
    convergence it is a large share of a small norm (measured on an H100 at
    N=20, kernel / dense: 1.7e-4 / 1.3e-4, 5.3e-3 / 1.9e-3, 0.043 / 0.036,
    0.094 / 0.111)."""
    config = T.SE3MPCConfig()
    prob = _gpu_problem(config, 4096, 12, cuda_device, n_obs=4)
    warm = T.shift_warm_start(config, T.solve(config, prob).thrusts)
    fused = cuda_mpc.solve_thrusts_fused
    launches = []

    def recorded(*args, **kwargs):
        out = fused(*args, **kwargs)
        launches.append(out)
        return out

    def withheld(*args, **kwargs):
        return fused(*args, **{**kwargs, "with_grad": False})

    monkeypatch.setattr(cuda_mpc, "solve_thrusts_fused", recorded)
    before = cuda_mpc.LAUNCHES
    res = T.solve(config, prob, warm)
    torch.cuda.synchronize()
    assert cuda_mpc.LAUNCHES == before + 2
    # phase 1 with the norm, the tail without
    assert [out.grad_norm is not None for out in launches] == [True, False]
    assert torch.equal(res.grad_norm, launches[0].grad_norm)
    u = launches[0][0]
    p64 = type(prob)(*[x.double() if x is not None and x.dtype.is_floating_point else x
                       for x in prob])
    exact = T.projected_grad_norm(config, p64, u.double())
    q = torch.tensor([0.5, 0.9, 0.99, 1.0], dtype=torch.float64, device=cuda_device)
    err_k = torch.quantile((res.grad_norm.double() - exact).abs(), q)
    err_d = torch.quantile((T.projected_grad_norm(config, prob, u).double() - exact).abs(), q)
    assert bool((err_k <= 4 * err_d + 1e-5).all()), (err_k.tolist(), err_d.tolist())
    monkeypatch.setattr(cuda_mpc, "solve_thrusts_fused", withheld)
    ref = T.solve(config, prob, warm)
    assert torch.equal(res.thrusts, ref.thrusts) and torch.equal(res.cost, ref.cost)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    prob = _gpu_problem(CFG, 4, 3, cuda_device)
    u0 = T.initialize_thrusts(CFG, prob)
    with pytest.raises(TypeError):
        cuda_mpc.solve_thrusts_fused(CFG, prob, u0.double())
    with pytest.raises(ValueError):
        cuda_mpc.solve_thrusts_fused(CFG, prob._replace(p0=prob.p0.cpu()), u0)
    # any horizon is taken (no ceiling), but u_init must end in (N, 3)
    long = CFG._replace(prediction_horizon=129)
    with pytest.raises(ValueError):
        cuda_mpc.solve_thrusts_fused(long, prob, torch.zeros(4, 128, 3, device=cuda_device))
    with pytest.raises(ValueError):
        cuda_mpc.solve_thrusts_fused(CFG, prob, u0[:, :-1])
