"""Long horizons (N > 64: three or more steps a lane of kernel B1), on the
CPU, against the JAX package.

- The port's plain solve (``solve(method="torch")``, the plain version of
  kernel B1's Newton loop) at N = 80, 100 and 160 is held against the JAX
  package's fused Pallas kernel (interpret mode) and its XLA path on the
  same numpy inputs: B=8, K=8, 2 rounds at CG-4 (CG-2 at N=160, where
  CG-4 branches in float32 in the JAX package too). Each scenario's cost
  within 1e-4 relative of both (float32 sums in another order, over up to
  480 thrusts; measured up to 7.0e-5, at N=100 against the XLA path),
  every scenario at or below its cold-start cost, and the mean
  cost within 5% (the aggregate contract of
  tests/test_pallas_mpc.py::test_generalizes_to_larger_horizon_and_obstacle_count).
- Kernel B1 has no horizon ceiling: it covers every horizon either
  package's front door accepts (the ``le`` bound of ``prediction_horizon``
  in both frozen configs) and any N >= 1 beyond.
- The kernel's own source, compiled for the CPU by g++ against
  ``csrc/emulation/cuda_runtime.h`` (a warp's lanes take turns on one
  CPU thread; shuffles and ballots meet through a buffer), runs one Newton round
  at CG-2 at one to eight steps a lane against the plain loop (at N=20 its
  16 scenarios are within one wave of one scenario a warp; the packed arm's
  cases are tests/test_torch_b1_packed.py's): thrusts
  within 2e-3 (float32 sums in another order), positions and velocities
  within 1e-4 of the exact (float64) rollout of its own thrusts, its cost
  within 1e-5 relative of their exact cost; and with 12 line-search alphas.
  From five steps a lane its arena moves from shared memory to a global
  scratch at SPILL_HORIZON, and the two give the same outputs bit for bit.
  These skip, with a reason, where there is no g++.

The kernel's constant block at N = 65-256 is checked in
tests/test_torch_cuda_mpc.py::test_kernel_constant_block_layout, the DI
planner at ``DART_PREDICTION_HORIZON=100`` in
tests/test_torch_config.py::test_config_planner_first_plan_matches_jax,
and the kernel itself at these horizons by the ``cuda`` tests of
tests/test_torch_cuda_mpc.py and ``chip_smoke.py`` phase 18.
"""

import ctypes

import numpy as np
import pytest
import torch

from dart_planner_tpu.config import frozen_config as J_fc
from dart_planner_tpu.planning import se3_mpc as J
from dart_planner_tpu_torch import interop
from dart_planner_tpu_torch.config import frozen_config as T_fc
from dart_planner_tpu_torch.ops import cuda_mpc
from dart_planner_tpu_torch.planning import se3_mpc as T
from _emulated_b1 import arrays as _arrays
from _emulated_b1 import bench_problem as _bench_problem
from _emulated_b1 import build_emulated_library
from _emulated_b1 import emulated_round as _emulated_round
from _torch_one_thread import one_torch_thread  # noqa: F401


# (N, CG iterations a round). At N=160 two rounds of CG-4 branch in float32
# even between the JAX package's own paths (its XLA path and fused kernel
# part by 1.48e-4 on one of these 8 scenarios, and the port's float32 loop
# from its float64 loop by 5.2e-4, where the line search takes another
# alpha; ROADMAP C.21); two rounds of CG-2 do not (the three paths within
# 4.3e-5 of each other), so there the rounds run at CG-2.
LONG_PARITY = [(80, 4), (100, 4), (160, 2)]


@pytest.mark.parametrize("N,cg", LONG_PARITY, ids=[f"{n}" for n, _ in LONG_PARITY])
def test_plain_solve_matches_jax_fused_and_xla_at_long_horizons(N, cg):
    B, K = 8, 8
    jcfg = J.SE3MPCConfig(prediction_horizon=N, max_iterations=2, cg_iterations=cg,
                          tail_iterations=0, max_obstacles=K)
    p0, v0, goal, obs = _arrays(np.random.default_rng(N), B, K)
    pj = J.make_problem(p0, v0, goal, obstacles=obs, config=jcfg)
    u0 = np.asarray(J.initialize_thrusts(jcfg, pj), np.float32)
    c0 = np.asarray(J._finalize(jcfg, pj, u0).cost, np.float32)
    rx = J.solve(jcfg, pj, u0, method="xla")
    rf = J.solve(jcfg, pj, u0, method="fused")  # the Pallas kernel, interpreted

    cfg = interop.config_from_jax_fields(jcfg)
    assert cfg.prediction_horizon == N
    pt = interop.problem_from_numpy(pj)
    rt = T.solve(cfg, pt, torch.tensor(u0), method="torch")
    ct = rt.cost.numpy()
    assert np.all(np.isfinite(ct))
    assert np.all(ct <= c0 + 1e-3)  # every scenario descends
    for ref in (rx, rf):
        cr = np.asarray(ref.cost, np.float32)
        np.testing.assert_allclose(ct, cr, rtol=1e-4)
        assert np.mean(ct) <= 1.05 * np.mean(cr) and np.mean(cr) <= 1.05 * np.mean(ct)


def _le(module) -> int:
    field = module.PlanningConfig.model_fields["prediction_horizon"]
    (le,) = [m.le for m in field.metadata if hasattr(m, "le")]
    return le


@pytest.mark.parametrize("module", [T_fc, J_fc], ids=["port", "jax"])
def test_kernel_horizon_covers_the_front_door(module, emulated_library):
    """Every horizon a frozen config accepts is one kernel B1 takes, and the
    wrapper refuses no N >= 1: it has no ceiling, and its launch
    (``run_library``, here through the emulated kernel) runs one round at
    N = 1, the front door's largest, past four steps a lane, and past
    the card's shared memory (N=1000: the arena in global scratch)."""
    assert _le(module) == 100
    assert not hasattr(cuda_mpc, "MAX_HORIZON")
    for N in (1, _le(module), 129, 1000):
        config = T.SE3MPCConfig(prediction_horizon=N, max_iterations=1, cg_iterations=2,
                                tail_iterations=0)
        prob = _bench_problem(config, 1, N)
        u0 = T.initialize_thrusts(config, prob)
        out = cuda_mpc.run_library(lambda: emulated_library, config, prob, u0, True, None)
        assert out[0].shape == (1, N, 3) and all(bool(torch.isfinite(x).all()) for x in out[:5])
        # the round keeps the cold start unless a candidate is cheaper
        assert float(out[4]) <= float(cuda_mpc.exact_cost(config, prob, u0)) * (1 + 1e-5)


@pytest.fixture(scope="module")
def emulated_library(tmp_path_factory):
    """``csrc/mpc_solve.cu`` and ``csrc/mpc_solve_steps.cu`` compiled by g++
    for the CPU as nvcc builds them (``_emulated_b1.build_emulated_library``),
    bound with the kernel's C interface."""
    return build_emulated_library(tmp_path_factory.mktemp("emulation"))


@pytest.mark.parametrize("N", [20, 65, 100, 128, 129, 160, 256])
@pytest.mark.parametrize("stage", ["gauss_newton", "full_curvature"])
def test_emulated_kernel_one_round_matches_plain(emulated_library, N, stage):
    config = T.SE3MPCConfig(prediction_horizon=N, max_iterations=1, cg_iterations=2,
                            tail_iterations=0,
                            gn_warmup_iterations=1 if stage == "gauss_newton" else 0)
    _emulated_round(emulated_library, config)


def test_emulated_kernel_takes_twelve_alphas(emulated_library):
    alphas = (0.005, 0.01, 0.02, 0.03, 0.06, 0.1, 0.18, 0.25, 0.35, 0.5, 0.7, 1.0)
    config = T.SE3MPCConfig(prediction_horizon=100, max_iterations=1, cg_iterations=2,
                            tail_iterations=0, line_search_alphas=alphas)
    k, _ = _emulated_round(emulated_library, config)
    k8, _ = _emulated_round(emulated_library, config._replace(line_search_alphas=alphas[:8]))
    assert not torch.equal(k8[0], k[0])  # the last four alphas are tried


# The smallest horizon whose arena (73 floats a step, 32 x ceil(N / 32) steps,
# beside 4K floats of spheres) passes an H100's 232,448 bytes of shared memory
# a block, as csrc/mpc_solve.cu's header states
SPILL_HORIZON = 769


@pytest.mark.parametrize("K", [0, 8, 512])
def test_emulated_kernel_arena_spills_past_shared_memory(emulated_library, K):
    """``mpc_scratch_floats`` asks for global scratch exactly when a warp's
    arena and its spheres pass the card's opt-in shared memory a block: from
    N = SPILL_HORIZON for any K <= 512, B x 32 x 73 x ceil(N / 32) floats;
    never below five steps a lane."""
    def scratch(N, B=3):
        params = cuda_mpc._params(T.SE3MPCConfig(prediction_horizon=N), B, K, True)
        return emulated_library.mpc_scratch_floats(ctypes.byref(params))

    assert [scratch(N) for N in (1, 128, 129, 160, SPILL_HORIZON - 1)] == [0] * 5
    for N in (SPILL_HORIZON, 1000):
        assert scratch(N) == 3 * 32 * 73 * -(-N // 32)


def test_emulated_kernel_global_arena_matches_shared(emulated_library):
    """The same kernel body with its arena in global scratch: with the
    card's shared memory set below one warp's arena, N=160 (five steps a
    lane) runs from a scratch the wrapper allocates and gives the shared
    arena's outputs bit for bit, within the one-round limits of the plain
    loop."""
    config = T.SE3MPCConfig(prediction_horizon=160, max_iterations=1, cg_iterations=2,
                            tail_iterations=0)
    params = cuda_mpc._params(config, 8, 8, True)
    assert emulated_library.mpc_scratch_floats(ctypes.byref(params)) == 0
    shared, _ = _emulated_round(emulated_library, config, batch=8)
    emulated_library.emu_set_smem_optin(16 * 1024)
    try:
        assert emulated_library.mpc_scratch_floats(ctypes.byref(params)) == 8 * 32 * 73 * 5
        spilled, _ = _emulated_round(emulated_library, config, batch=8)
    finally:
        emulated_library.emu_set_smem_optin(232448)
    for a, b in zip(shared[:5], spilled[:5]):
        assert torch.equal(a, b)


def test_run_library_counts_a_launch_on_a_stream(emulated_library, monkeypatch):
    """``LAUNCHES`` rises where the kernel is launched, in ``run_library``,
    so every caller of it counts: once a launch on a stream (0 is the
    default CUDA stream), never for a library built for the CPU
    (``stream=None``) or an empty batch. The counter is restored after the
    test: a later test in the same process may read it whole."""
    monkeypatch.setattr(cuda_mpc, "LAUNCHES", cuda_mpc.LAUNCHES)
    config = T.SE3MPCConfig(prediction_horizon=20, max_iterations=1, cg_iterations=2,
                            tail_iterations=0)
    prob = _bench_problem(config, 2, 20)
    u0 = T.initialize_thrusts(config, prob)

    def launch(batch, stream):
        part = T.costs.Problem(*[None if x is None else x[:batch] for x in prob])
        before = cuda_mpc.LAUNCHES
        out = cuda_mpc.run_library(lambda: emulated_library, config, part, u0[:batch], True,
                                   stream)
        return out, cuda_mpc.LAUNCHES - before

    on_cpu, n_cpu = launch(2, None)
    on_stream, n_stream = launch(2, 0)
    _, n_empty = launch(0, 0)
    assert (n_cpu, n_stream, n_empty) == (0, 1, 0)
    for a, b in zip(on_cpu[:5], on_stream[:5]):
        assert torch.equal(a, b)
