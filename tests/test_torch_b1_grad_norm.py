"""Kernel B1's projected-gradient norm of its final iterate, on the CPU,
through the kernel's own source compiled by g++ (``_emulated_b1``; these
tests skip, with a reason, where there is no g++).

- With ``with_grad`` a launch passes ``gnorm_out`` and the kernel writes
  ``||clamp(u - g, lb, ub) - u||`` at its final thrusts, g from the same
  gradient code as a Newton round's start. It matches
  ``se3_mpc.projected_grad_norm``, the dense formula of the plain path,
  evaluated in float64 on the same thrusts and problem, at N = 20, 40, 80,
  100 and 160 (one to four steps a lane and the run-time arm), with live
  spheres, the ground, a velocity cap, the tilt and thrust-norm hinges
  active and thrusts at a bound, after a Gauss-Newton and a
  full-curvature round: to 1e-3 relative and 1e-3 absolute. The kernel's
  norm is a float32 one: its rollout and pull-back scans round, and the
  hinge weights (the ground's is 5e4) scale a position's rounding into
  the gradient; clamp(u - g) - u loses about an ulp of u (~2e-6 N) a
  thrust. Measured here up to 1.2e-4 relative (N=160), as far as the
  dense float32 formula's own 7.7e-5 (a missing effort or hinge term
  moves the norm by percents).
- The launch's other outputs (thrusts, positions, velocities, the
  smallest improvement, the cost) are the same bit for bit with and
  without the pointer: the norm's pass only reads the final iterate.
- A null pointer writes nothing (the emulated launch would fault on it);
  with one, exactly B floats are written.
- A solve through the emulated kernel takes its norm from the launch:
  ``_finalize`` runs no dense gradient, and ``finalize_grad_norms`` counts
  one ``kernel`` norm a solve (the tail pass asks for none).
"""

import ctypes

import numpy as np
import pytest
import torch

from dart_planner_tpu_torch.common.metrics import get_metrics
from dart_planner_tpu_torch.ops import costs, cuda_mpc, dynamics
from dart_planner_tpu_torch.planning import se3_mpc as T
from _emulated_b1 import build_emulated_library
from _torch_one_thread import one_torch_thread  # noqa: F401

HORIZONS = [20, 40, 80, 100, 160]  # S = 1, 2, 3, 4 and the run-time arm


@pytest.fixture(scope="module")
def emulated_library(tmp_path_factory):
    return build_emulated_library(tmp_path_factory.mktemp("emulation"))


def _config(N):
    """A Gauss-Newton round, then a full-curvature one."""
    return T.SE3MPCConfig(prediction_horizon=N, max_iterations=2, gn_warmup_iterations=1,
                          cg_iterations=2, tail_iterations=0)


def _problem(config, batch, seed):
    """Vehicles just above the ground, falling, with a goal 8-12 m away and
    four spheres on the way, under a 1.5 m/s cap: after a few rounds every
    hinge is active and thrusts sit at the box's bounds."""
    rng = np.random.default_rng(seed)
    p0 = np.stack([rng.uniform(-1, 1, batch), rng.uniform(-1, 1, batch),
                   rng.uniform(0.4, 1.0, batch)], -1)
    v0 = np.stack([rng.normal(0, 1, batch), rng.normal(0, 1, batch),
                   rng.uniform(-4, -2, batch)], -1)
    goal = np.stack([rng.uniform(8, 12, batch), rng.uniform(-3, 3, batch),
                     rng.uniform(2, 6, batch)], -1)
    t = rng.uniform(0.3, 0.6, (batch, 4, 1))
    centers = p0[:, None] * (1 - t) + goal[:, None] * t + rng.normal(0, 0.3, (batch, 4, 3))
    obs = np.concatenate([centers, rng.uniform(0.4, 1.0, (batch, 4, 1))], -1)
    prob = T.make_problem(*(x.astype(np.float32) for x in (p0, v0, goal)),
                          obstacles=obs.astype(np.float32), config=config, device="cpu")
    return prob._replace(v_cap=torch.full((batch,), 1.5))


def _exact_norm(config, prob, u):
    """The dense formula's norm in float64 from the same float32 inputs."""
    p64 = costs.Problem(*[x.double() if x is not None and x.dtype.is_floating_point else x
                          for x in prob])
    return T.projected_grad_norm(config, p64, u.double())


def _active(config, prob, u):
    """Scenarios in which each hinge is active at ``u``, and those with a
    thrust at a bound of the box."""
    w = config.weights
    g = torch.tensor([0.0, 0.0, -config.gravity])
    pos, vel, _ = dynamics.rollout_linear(u, prob.p0, prob.v0, config.dt, config.mass, g)
    lat = torch.linalg.vector_norm(u[..., :2], dim=-1)
    lb, ub = config.thrust_bounds()
    terms = {
        "obstacle": costs.obstacle_penalty(pos, prob.obstacles, prob.obstacle_mask) > 0,
        "ground": (pos[..., 2] < w.ground_altitude).any(-1),
        "velocity": (vel.abs() > costs.effective_vmax(prob, w)).flatten(-2).any(-1),
        "tilt": (lat > w.tan_max_tilt * u[..., 2]).any(-1),
        "thrust_norm": (torch.linalg.vector_norm(u, dim=-1) > w.max_thrust_norm).any(-1),
        "bound": ((u <= lb) | (u >= ub)).flatten(-2).any(-1),
    }
    return {name: int(on.sum()) for name, on in terms.items()}


@pytest.mark.parametrize("N", HORIZONS)
def test_kernel_norm_matches_the_dense_formula_and_leaves_the_outputs(emulated_library, N):
    config = _config(N)
    prob = _problem(config, 2, N)
    u0 = T.initialize_thrusts(config, prob)
    args = (lambda: emulated_library, config, prob, u0, True, None)
    with_norm = cuda_mpc.run_library(*args, with_grad=True)
    without = cuda_mpc.run_library(*args)
    assert with_norm.grad_norm is not None and without.grad_norm is None
    for a, b in zip(with_norm[:5], without[:5]):
        assert torch.equal(a, b)
    u, norm = with_norm.thrusts, with_norm.grad_norm
    act = _active(config, prob, u)
    assert all(n > 0 for n in act.values()), act
    torch.testing.assert_close(norm.double(), _exact_norm(config, prob, u), rtol=1e-3,
                               atol=1e-3)


def test_null_pointer_writes_nothing(emulated_library):
    """Straight through the C interface: with a pointer the launch writes
    B floats and not the guard after them; with a null one it completes
    and its outputs are the same bit for bit."""
    config = _config(20)
    B, N = 4, 20
    prob = _problem(config, B, 1)
    K = prob.obstacles.shape[-2]
    u0 = T.initialize_thrusts(config, prob)
    # the launch's inputs, contiguous float32, held for its duration
    inputs = [x.float().contiguous() for x in (
        u0, prob.p0, prob.v0, prob.goal[:, None, :].expand(B, N, 3), prob.obstacles,
        prob.obstacle_mask, prob.v_cap)]
    params = cuda_mpc._params(config, B, K, True)
    consts = cuda_mpc.constants_host(config)

    def launch(gnorm):
        outs = [torch.full((B, N, 3), float("nan")) for _ in range(3)]
        outs += [torch.full((B,), float("nan")) for _ in range(2)]
        err = emulated_library.mpc_solve_launch(
            ctypes.byref(params), consts.data_ptr(), *(x.data_ptr() for x in inputs),
            *(x.data_ptr() for x in outs), None if gnorm is None else gnorm.data_ptr(),
            None, None, None)
        assert err == 0
        return outs

    gnorm = torch.full((B + 1,), float("nan"))
    with_ptr = launch(gnorm)
    assert bool(torch.isfinite(gnorm[:B]).all()) and bool(torch.isnan(gnorm[B]))
    for a, b in zip(launch(None), with_ptr):
        assert torch.equal(a, b)


@pytest.mark.parametrize("tail", [0, 1])
def test_solve_takes_the_kernels_norm(emulated_library, monkeypatch, tail):
    """``se3_mpc.solve`` through the emulated kernel, as on the card: phase
    1's launch brings the norm, ``_finalize`` runs no dense gradient
    (``condensed_grad`` raises here), the counter says ``kernel`` once a
    solve and ``dense`` never; without a tail the norm is the float64 dense
    formula's on the solve's own thrusts, as in the launch's test."""
    def fused(config, prob, u_init, use_obstacles=True, solve_pass="phase1", with_grad=False):
        return cuda_mpc.run_library(lambda: emulated_library, config, prob, u_init,
                                    use_obstacles, None, solve_pass, with_grad)

    def refuse(*args, **kwargs):
        raise AssertionError("a dense gradient on the kernel's path")

    config = _config(20)._replace(tail_iterations=tail, tail_cg_iterations=2)
    prob = _problem(config, 4, 2)
    monkeypatch.setattr(T, "resolve_method", lambda prob, method: "cuda")
    monkeypatch.setattr(cuda_mpc, "solve_thrusts_fused", fused)
    u0 = T.initialize_thrusts(config, prob)  # the cold start's QP uses the gradient
    before = get_metrics().series("finalize_grad_norms")
    with monkeypatch.context() as m:
        m.setattr(costs, "condensed_grad", refuse)
        res = T.solve(config, prob, u0)
    after = get_metrics().series("finalize_grad_norms")
    rose = {dict(k)["source"]: n - before.get(k, 0) for k, n in after.items()}
    assert rose.get("kernel", 0) == 1 and rose.get("dense", 0) == 0
    assert res.grad_norm.shape == (4,)
    if not tail:
        torch.testing.assert_close(res.grad_norm.double(),
                                   _exact_norm(config, prob, res.thrusts), rtol=1e-3, atol=1e-3)
