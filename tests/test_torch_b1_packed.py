"""Kernel B1's packed arm (N <= 32 past one wave of the one-scenario-a-warp
arm: four scenarios a warp, each on a segment of 8 lanes, ceil(N / 8)
consecutive steps a lane), on the CPU, through the kernel's own source
compiled by g++ (``_emulated_b1``; these tests skip, with a reason, where
there is no g++). The emulated card here has one SM, so that one wave of
one scenario a warp is 16 scenarios and a batch of 17 is packed.

- The arm by the batch: up to 16 scenarios one a warp, from 17 four.
- One Newton round at CG-2 against the plain twin
  ``se3_mpc.solve_thrusts_plain`` at N = 1, 8 (one step a lane), 9 (two),
  20, 24 (three, the curvature in shared memory), 25 and 32 (four), in
  both curvature stages, with batches of 19 and 29, so that the last warp
  holds segments past the batch: the one-round limits of
  ``_emulated_b1.emulated_round``.
- No value crosses a segment (``_emulated_b1.check_segment_isolation``):
  each scenario's outputs are the same bit for bit alone in its warp (the
  other segments run copies of it) and beside three others, in either
  order. One of the four breaks CG on negative curvature at its first
  step, so its segment stays frozen while its warp-mates iterate.
- The counter ``b1_launches`` labels each launch with the scenarios a warp
  of its arm (``per_warp``): 4 at N=20, 1 at N=40 and at N=20 within one
  wave, beside the same ``pass``, ``steps`` and ``arena`` as before, on
  ``/metrics`` too.
"""

import ctypes

import pytest
import torch

from dart_planner_tpu_torch.common.metrics import get_metrics
from dart_planner_tpu_torch.ops import cuda_mpc
from dart_planner_tpu_torch.planning import se3_mpc as T
from _emulated_b1 import (bench_problem, build_emulated_library, check_segment_isolation,
                          emulated_round)
from _torch_one_thread import one_torch_thread  # noqa: F401

PACKED_HORIZONS = [1, 8, 9, 20, 24, 25, 32]


# one wave of one scenario a warp on the emulated card of one SM
WAVE = 16


@pytest.fixture(scope="module")
def emulated_library(tmp_path_factory):
    lib = build_emulated_library(tmp_path_factory.mktemp("emulation"))
    lib.emu_set_sm_count(1)
    return lib


def test_packed_arm_takes_batches_past_one_wave(emulated_library):
    def per_warp(N, B):
        params = cuda_mpc._params(T.SE3MPCConfig(prediction_horizon=N), B, 8, True)
        return emulated_library.mpc_scenarios_per_warp(ctypes.byref(params))

    assert [per_warp(20, B) for B in (1, WAVE, WAVE + 1, 131072)] == [1, 1, 4, 4]
    assert [per_warp(N, 131072) for N in (1, 32, 33, 100)] == [4, 4, 1, 1]


@pytest.mark.parametrize("B", [19, 29])
@pytest.mark.parametrize("stage", ["gauss_newton", "full_curvature"])
@pytest.mark.parametrize("N", PACKED_HORIZONS)
def test_packed_arm_one_round_matches_plain(emulated_library, N, stage, B):
    config = T.SE3MPCConfig(prediction_horizon=N, max_iterations=1, cg_iterations=2,
                            tail_iterations=0,
                            gn_warmup_iterations=1 if stage == "gauss_newton" else 0)
    emulated_round(emulated_library, config, batch=B)


def test_packed_arm_scenario_is_alone_in_its_segment(emulated_library):
    def solve(config, prob, u0):
        return cuda_mpc.run_library(lambda: emulated_library, config, prob, u0, True, None)

    check_segment_isolation(solve, "cpu", WAVE + 1)


@pytest.fixture
def fresh():
    get_metrics().reset()
    yield get_metrics()
    get_metrics().reset()


def test_b1_launches_label_the_scenarios_a_warp(fresh, emulated_library):
    for N, B, per_warp in ((20, WAVE + 1, 4), (40, WAVE + 1, 1), (20, WAVE, 1)):
        config = T.SE3MPCConfig(prediction_horizon=N, max_iterations=1, cg_iterations=2,
                                tail_iterations=0)
        prob = bench_problem(config, B, N)
        u0 = T.initialize_thrusts(config, prob)
        before = fresh.series("b1_launches")
        cuda_mpc.run_library(lambda: emulated_library, config, prob, u0, True, None)
        rose = {k: n - before.get(k, 0) for k, n in fresh.series("b1_launches").items()
                if n > before.get(k, 0)}
        steps = -(-N // 32)
        assert rose == {(("arena", "shared"), ("pass", "phase1"), ("per_warp", str(per_warp)),
                         ("steps", str(steps))): 1}
    text = fresh.prometheus_exposition()
    assert 'dart_b1_launches_total{arena="shared",pass="phase1",per_warp="4",steps="1"} 1' in text
    assert 'dart_b1_launches_total{arena="shared",pass="phase1",per_warp="1",steps="2"} 1' in text
    assert 'dart_b1_launches_total{arena="shared",pass="phase1",per_warp="1",steps="1"} 1' in text
