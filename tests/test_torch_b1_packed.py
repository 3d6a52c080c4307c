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
- The packed arm's order by live spheres (``cuda_mpc.order_mask``): at one,
  three and four steps a segment's lane (N = 8, 20, 32), a batch with 0 to
  K live spheres a scenario gives bit for bit what it gives in the order
  given, and a permuted batch the permuted outputs
  (``_emulated_b1.check_live_order``); the span ``b1.order`` times the
  order, under the profiler one range inside ``b1.wrapper`` with no sync.
  Within one wave, past N = 32, without spheres, with one mask for the
  batch (``make_problem``'s default among them) and with no sphere slot
  the wrapper runs the same tensor
  operations as a launch in the order given: no sort, no span. The C
  interface refuses an order on an arm of one scenario a warp. Through
  ``se3_mpc.solve``, phase 1 and the tail, ``make_problem``'s default mask
  stays one row for the batch and orders neither launch.
"""

import ctypes

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from dart_planner_tpu_torch.common.metrics import get_metrics
from dart_planner_tpu_torch.ops import cuda_mpc
from dart_planner_tpu_torch.planning import se3_mpc as T
from _emulated_b1 import (bench_problem, build_emulated_library, check_live_order,
                          check_segment_isolation, emulated_round, mixed_spheres)
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


def _run(library, use_obstacles=True):
    def solve(config, prob, u0):
        return cuda_mpc.run_library(lambda: library, config, prob, u0, use_obstacles, None,
                                    with_grad=True)

    return solve


@pytest.mark.parametrize("N", [8, 20, 32])
def test_live_order_is_invisible_on_the_packed_arm(fresh, emulated_library, monkeypatch, N):
    config = T.SE3MPCConfig(prediction_horizon=N, max_obstacles=11, tail_iterations=0)
    prob = mixed_spheres(config, 3 * WAVE + 5, N)
    check_live_order(_run(emulated_library), config, prob, monkeypatch)
    # two ordered launches: the batch and its permutation
    assert len(fresh.history("b1.order")) == 2


def test_live_order_is_a_span_inside_the_wrapper(fresh, emulated_library):
    """Under the profiler (tier 1) an ordered launch opens one ``b1.order``
    range inside ``b1.wrapper`` and makes no host sync."""
    config = T.SE3MPCConfig(max_obstacles=11, max_iterations=1, cg_iterations=2,
                            tail_iterations=0)
    prob = mixed_spheres(config, 2 * WAVE + 3, 3)
    u0 = T.initialize_thrusts(config, prob)
    solve = _run(emulated_library)
    solve(config, prob, u0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        solve(config, prob, u0)
    ranges = {e.name: e.time_range for e in prof.events()
              if e.name in ("b1.wrapper", "b1.order")}
    orders = [e.time_range for e in prof.events() if e.name == "b1.order"]
    assert len(orders) == 1 and "b1.wrapper" in ranges
    wrapper = ranges["b1.wrapper"]
    assert wrapper.start <= orders[0].start and orders[0].end <= wrapper.end
    assert fresh.span_counts() == {"calls": {"b1.wrapper": 1, "b1.order": 1}, "syncs": {}}


@pytest.mark.parametrize("N,B", [(20, WAVE), (40, 3 * WAVE)])
def test_an_order_on_an_arm_of_one_scenario_a_warp_is_refused(emulated_library, monkeypatch,
                                                              N, B):
    config = T.SE3MPCConfig(prediction_horizon=N, max_obstacles=11, max_iterations=1,
                            cg_iterations=2, tail_iterations=0)
    prob = mixed_spheres(config, B, 5)
    monkeypatch.setattr(cuda_mpc, "order_mask", lambda prob, *args: prob.obstacle_mask)
    with pytest.raises(RuntimeError, match="CUDA error 1 "):
        _run(emulated_library)(config, prob, T.initialize_thrusts(config, prob))


class _Ops(TorchDispatchMode):
    """The aten operations run while it is on."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", ["one_wave", "two_steps", "no_spheres", "one_mask",
                                  "default_mask", "no_slot", "packed"])
def test_live_order_only_on_the_packed_arm_with_spheres(fresh, emulated_library, monkeypatch,
                                                        case):
    K = 0 if case == "no_slot" else 11
    config = T.SE3MPCConfig(prediction_horizon=40 if case == "two_steps" else 20,
                            max_obstacles=K, max_iterations=1, cg_iterations=2,
                            tail_iterations=0)
    B = WAVE if case == "one_wave" else 2 * WAVE + 3
    prob = mixed_spheres(config, B, 7)
    if case == "default_mask":  # make_problem's: one row for the batch
        prob = bench_problem(config, B, 7)
        assert prob.obstacle_mask.stride()[0] == 0
    if case == "one_mask":
        prob = prob._replace(obstacle_mask=prob.obstacle_mask[0])
    u0 = T.initialize_thrusts(config, prob)
    solve = _run(emulated_library, use_obstacles=case != "no_spheres")

    solve(config, prob, u0)  # the device constants, made once
    fresh.reset()

    def ops():
        with _Ops() as seen:
            out = solve(config, prob, u0)
        return seen.ops, out

    ops_ordered, out = ops()
    with monkeypatch.context() as m:
        m.setattr(cuda_mpc, "order_mask", lambda *args: None)
        ops_given, given = ops()
    for a, b in zip(out, given):
        assert torch.equal(a, b)
    # the order: the live count's sum and the sort, and nothing else
    extra = [op for op in ops_ordered if op not in ops_given]
    if case == "packed":
        assert extra and {"aten.sum", "aten.sort"} <= set(extra), extra
        assert not {"aten.index_select", "aten.index", "aten.index_copy_"} & set(ops_ordered)
        assert len(fresh.history("b1.order")) == 1
    else:
        assert ops_ordered == ops_given and "aten.sort" not in ops_ordered, ops_ordered
        assert fresh.history("b1.order") == []


@pytest.mark.parametrize("mask", ["shared", "mixed"])
def test_the_two_phase_solve_orders_only_a_mask_that_differs(fresh, emulated_library,
                                                             monkeypatch, mask):
    """``se3_mpc.solve`` through the emulated kernel, phase 1 and the tail
    both on the packed arm (69 scenarios, a tail of 18): ``make_problem``'s
    default mask, one row for the batch as the fleet's replans build it,
    reaches both launches shared through the tail's compaction, so neither
    builds an order; a mask of 0 to K live spheres a scenario orders both."""
    def fused(config, prob, u_init, use_obstacles=True, solve_pass="phase1", with_grad=False):
        return cuda_mpc.run_library(lambda: emulated_library, config, prob, u_init,
                                    use_obstacles, None, solve_pass, with_grad)

    config = T.SE3MPCConfig(max_obstacles=8, max_iterations=1, cg_iterations=2,
                            tail_iterations=1, tail_cg_iterations=2)
    B = 4 * WAVE + 5
    prob = bench_problem(config, B, 9) if mask == "shared" else mixed_spheres(config, B, 9)
    monkeypatch.setattr(T, "resolve_method", lambda prob, method: "cuda")
    monkeypatch.setattr(cuda_mpc, "solve_thrusts_fused", fused)
    T.solve(config, prob)
    launches = get_metrics().series("b1_launches")
    assert {dict(k)["pass"]: (dict(k)["per_warp"], n) for k, n in launches.items()} == {
        "phase1": ("4", 1), "tail": ("4", 1)}
    assert len(fresh.history("b1.order")) == (0 if mask == "shared" else 2)
