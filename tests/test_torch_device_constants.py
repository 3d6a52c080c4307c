"""The solve's and the closed loop's device constants
(``ops/device_constants.py``), on the CPU.

- A second call for one key returns the same tensor object; another horizon,
  step or dtype returns another tensor; ``"cpu"`` and ``torch.device("cpu")``
  name one key. The cache is bounded.
- Every cached tensor equals the float64 numpy construction cast to its
  dtype, bit for bit (the plain Newton loop's maps divided by the mass, as
  the loop always did, in that dtype).
- ``device_constant_uploads`` rises once per new key and not on a hit.
- After a two-phase solve with its restart and a short episode on the CPU,
  every cached tensor still holds its value: no caller wrote into one.

The card's side (no sync in a warm replan, ``"cuda"`` and ``"cuda:0"`` one
entry) is ``tests/test_torch_trace.py``'s ``cuda`` test.
"""

import numpy as np
import pytest
import torch

from dart_planner_tpu_torch.common.metrics import get_metrics
from dart_planner_tpu_torch.common.types import DroneState
from dart_planner_tpu_torch.ops import costs, cuda_mpc, cuda_rollout, device_constants, dynamics
from dart_planner_tpu_torch.ops.device_constants import device_constant, vector
from dart_planner_tpu_torch.planning import se3_mpc
from dart_planner_tpu_torch.sim import closed_loop
from _torch_one_thread import one_torch_thread  # noqa: F401

CFG = se3_mpc.SE3MPCConfig(prediction_horizon=8, max_iterations=4, cg_iterations=6,
                           tail_iterations=2, restart_iterations=2)
LOOP = closed_loop.ClosedLoopConfig(
    mpc=CFG._replace(tail_iterations=0, restart_iterations=0, goal_margin_clamp=0.5),
    num_replans=3, substeps_per_plan=8, sense_radius=3.0,
)
DTYPES = (torch.float32, torch.float64)
NP = {torch.float32: np.float32, torch.float64: np.float64}


def _uploads() -> int:
    return get_metrics().all_summaries()["counters"].get("device_constant_uploads", 0)


def _constants(config, dtype, device="cpu") -> dict:
    """Every device constant the solve and the loop take for ``config``,
    by name; each accessor as its caller calls it."""
    N, dt, mass = config.prediction_horizon, config.dt, config.mass
    kw = dict(dtype=dtype, device=device)
    S_p, S_v, t = dynamics.rollout_maps(N, dt, dtype, device)
    Sp, Sv = dynamics.scaled_maps(N, dt, mass, dtype, device)
    SpT_m, SvT_m, Sp2T, Sv2T = device_constant(se3_mpc._newton_maps_on, N, float(dt), mass,
                                               **kw)[2:]
    S_pT, S_vT = device_constant(costs._transposed_maps_on, N, float(dt), **kw)
    lb, ub = config.thrust_bounds(dtype, device)
    out = {
        "S_p": S_p, "S_v": S_v, "t": t, "S_p/m": Sp, "S_v/m": Sv, "(S_p/m)^T": SpT_m,
        "(S_v/m)^T": SvT_m, "((S_p/m)^2)^T": Sp2T, "((S_v/m)^2)^T": Sv2T, "S_p^T": S_pT,
        "S_v^T": S_vT, "lb": lb, "ub": ub,
        "gravity": se3_mpc._gravity(config, dtype, device),
        "hover": vector((0.0, 0.0, config.hover_thrust), dtype, device),
        "e3": vector((0.0, 0.0, 1.0), dtype, device),
        "Hinv": device_constant(se3_mpc._hessian_inverse_on, config, **kw),
        "H": device_constant(se3_mpc._hessian_on, N, dt, mass, config.gravity, config.weights,
                             **kw),
        "alphas": vector(config.line_search_alphas, dtype, device),
        "lerp": cuda_rollout._lerp_tensor(LOOP.substeps_per_plan, LOOP.control_dt, config.dt,
                                          N, dtype, device),
    }
    if dtype == torch.float32:
        out["b1"] = device_constant(cuda_mpc._constants_on, config, **kw)
    return out


def _numpy(config, dtype) -> dict:
    """The same constants from their float64 numpy construction, cast."""
    f = NP[dtype]
    N, dt, mass = config.prediction_horizon, config.dt, config.mass
    S_p, S_v, t = (m.astype(f) for m in dynamics.rollout_matrices(N, dt))
    Sp, Sv = S_p / f(mass), S_v / f(mass)
    lb, ub = config.thrust_bound_values()
    out = {
        "S_p": S_p, "S_v": S_v, "t": t, "S_p/m": Sp, "S_v/m": Sv, "(S_p/m)^T": Sp.T,
        "(S_v/m)^T": Sv.T, "((S_p/m)^2)^T": (Sp * Sp).T, "((S_v/m)^2)^T": (Sv * Sv).T,
        "S_p^T": S_p.T, "S_v^T": S_v.T, "lb": np.array(lb, f), "ub": np.array(ub, f),
        "gravity": np.array([0.0, 0.0, -config.gravity], f),
        "hover": np.array([0.0, 0.0, config.mass * config.gravity], f),
        "e3": np.array([0.0, 0.0, 1.0], f),
        "Hinv": se3_mpc._quadratic_hessian_inverse(config).astype(f),
        "H": costs.quadratic_hessian(N, dt, mass, config.gravity, config.weights).astype(f),
        "alphas": np.array(config.line_search_alphas, f),
        "lerp": cuda_rollout._lerp_weights(LOOP.substeps_per_plan, LOOP.control_dt, config.dt,
                                           N).astype(f),
    }
    if dtype == torch.float32:
        out["b1"] = cuda_mpc.constants_host(config).numpy()
    return out


def _same_bits(x: torch.Tensor, ref: np.ndarray) -> bool:
    got = x.numpy()
    return got.shape == ref.shape and got.dtype == ref.dtype and (
        np.ascontiguousarray(got).tobytes() == np.ascontiguousarray(ref).tobytes())


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_second_call_returns_the_same_tensor(dtype):
    first = _constants(CFG, dtype)
    again = _constants(CFG, dtype, torch.device("cpu"))
    for name, x in first.items():
        assert again[name] is x, name


def test_another_horizon_step_or_dtype_is_another_tensor():
    base = dynamics.rollout_maps(8, 0.1, torch.float32, "cpu")
    for other in (dynamics.rollout_maps(9, 0.1, torch.float32, "cpu"),
                  dynamics.rollout_maps(8, 0.05, torch.float32, "cpu"),
                  dynamics.rollout_maps(8, 0.1, torch.float64, "cpu")):
        assert all(o is not b for o, b in zip(other, base))
    assert dynamics.rollout_maps(8, 0.1, torch.float32, "cpu") is base
    g = se3_mpc._gravity(CFG, torch.float32, "cpu")
    assert se3_mpc._gravity(CFG._replace(gravity=9.8), torch.float32, "cpu") is not g
    assert se3_mpc._gravity(CFG._replace(prediction_horizon=5), torch.float32, "cpu") is g
    assert device_constants.normal_device("cpu") == torch.device("cpu")
    assert device_constants._cached.cache_info().maxsize == device_constants._MAX_ENTRIES


@pytest.mark.parametrize("dtype", DTYPES)
def test_every_constant_equals_its_numpy_construction_bit_for_bit(dtype):
    got, want = _constants(CFG, dtype), _numpy(CFG, dtype)
    assert got.keys() == want.keys()
    for name, x in got.items():
        assert x.dtype == dtype and x.device.type == "cpu", name
        assert _same_bits(x, want[name]), name


def test_the_counter_rises_once_per_new_key_and_not_on_a_hit():
    N, dt = 13, 0.0371  # a key no other test of the process takes
    before = _uploads()
    maps = dynamics.rollout_maps(N, dt, torch.float32, "cpu")
    assert _uploads() == before + 1
    assert dynamics.rollout_maps(N, dt, torch.float32, torch.device("cpu")) is maps
    assert _uploads() == before + 1
    dynamics.scaled_maps(N, dt, 1.5, torch.float32, "cpu")  # its maps are cached
    assert _uploads() == before + 2
    dynamics.scaled_maps(N, dt, 1.5, torch.float32, "cpu")
    dynamics.rollout_maps(N, dt, torch.float64, "cpu")
    assert _uploads() == before + 3


def _problem(batch: int, seed: int):
    rng = np.random.default_rng(seed)
    obs = np.concatenate([rng.normal(0, 3, (batch, 3, 3)), rng.uniform(0.3, 1.0, (batch, 3, 1))],
                         -1).astype(np.float32)
    p0 = (rng.normal(0, 2, (batch, 3)) + [0, 0, 5]).astype(np.float32)
    v0 = rng.normal(0, 1, (batch, 3)).astype(np.float32)
    goal = (rng.normal(0, 3, (batch, 3)) + [0, 0, 5]).astype(np.float32)
    return p0, v0, goal, obs


def test_no_caller_writes_into_a_constant():
    """A two-phase solve with its restart (the plain Newton loop, the cold
    start, every ``_finalize``), a trajectory extraction and a short episode
    through the packed tick block's plain version, with sensing, noise and
    the margin clamp: every constant keeps its bits."""
    kept = {k: v.clone() for k, v in _constants(CFG, torch.float32).items()}
    kept.update({f"loop.{k}": v.clone() for k, v in _constants(LOOP.mpc, torch.float32).items()})
    p0, v0, goal, obs = _problem(6, 11)
    prob = se3_mpc.make_problem(p0, v0, goal, obstacles=obs, config=CFG, device="cpu")
    res = se3_mpc.solve(CFG, prob)
    res = se3_mpc.solve(CFG, prob, se3_mpc.shift_warm_start(CFG, res.thrusts))
    se3_mpc.extract_trajectory(CFG, res, torch.zeros(6))
    se3_mpc.initialize_thrusts(CFG, prob, "hover").add_(1.0)  # the caller's own copy
    one = CFG._replace(prediction_horizon=1)  # an expanded view already contiguous
    single = se3_mpc.make_problem(p0[0], v0[0], goal[0], config=one, device="cpu")
    se3_mpc.initialize_thrusts(one, single, "hover").add_(1.0)
    costs.obstacle_gn_hessian(res.thrusts, prob, CFG.weights, CFG.dt, CFG.mass,
                              se3_mpc._gravity(CFG, torch.float32, "cpu"))
    for method in ("torch", "fused"):
        ep = closed_loop.simulate_episode(
            LOOP, None, DroneState.zeros((6,), device="cpu").replace(
                position=torch.as_tensor(p0)), torch.as_tensor(goal),
            obstacles=torch.as_tensor(obs[0]), method=method,
            wind=torch.full((6, 3), 0.3), noise=torch.full((3, 6, 6), 0.01))
        assert bool(torch.isfinite(ep.final_position).all())
    now = _constants(CFG, torch.float32)
    now.update({f"loop.{k}": v for k, v in _constants(LOOP.mpc, torch.float32).items()})
    for name, x in kept.items():
        assert torch.equal(now[name], x), name
