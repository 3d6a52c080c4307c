"""The port's stage spans (``common/metrics.py``'s ``span``) and the
benchmark's readers of them, on the CPU.

- Every span of the solve and the closed loop is recorded under its name
  (tier 0) by a two-phase solve with its tail and restart, by an episode
  through the packed tick block's plain version, and ``b1.wrapper`` by a
  launch of kernel B1's emulated library.
- The counter ``b1_launches`` rises once under each pass of a two-phase
  solve through the emulated B1, labelled with the arm (steps a lane, the
  arena, the scenarios a warp), and ``b1.wrapper.<pass>`` holds each pass's wrapper time.
- Without the profiler no span opens a ``record_function`` range; under a
  CPU ``torch.profiler`` each opens one of its name, nested as the stages
  nest, counts its calls, and counts the warnings with torch's sync message
  raised while it is the innermost open span (tier 1), restoring the sync
  debug mode and the warning filters after, and leaving a mode of "warn"
  or "error" that the process set alone. The counts only rise. Outputs are
  bitwise equal with tier 1 on and off.
- Each reader of ``benchmark/metrics`` that reads the spans returns None
  for an empty context and its formula's value for a filled manager.

On the card (marked ``cuda``): one upload from pageable host memory inside
a span under the profiler counts one sync; a warm two-phase solve, its
extraction and a short episode through B1 and B2 make none (sync debug mode
"error") and no device constant; a warm two-phase solve at N = 20 and 100
adds one phase-1 and one tail launch to ``b1_launches`` without a sync.
"""

import importlib.util
import pathlib
import statistics
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dart_planner_tpu_torch.common import metrics
from dart_planner_tpu_torch.common.metrics import SYNC_MESSAGE, get_metrics, span
from dart_planner_tpu_torch.common.types import DroneState
from dart_planner_tpu_torch.ops import cuda_mpc
from dart_planner_tpu_torch.planning import se3_mpc
from dart_planner_tpu_torch.sim import closed_loop
from _emulated_b1 import build_emulated_library
from _torch_one_thread import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]

# each span and the spans it may sit in (None: no program span around it)
PARENTS = {
    "mpc.make_problem": {None},
    "mpc.solve": {None, "loop.replan"},
    "mpc.cold_start": {"mpc.solve", "mpc.restart"},
    "mpc.finalize": {"mpc.solve", "mpc.tail", "mpc.restart"},
    "mpc.tail": {"mpc.solve"},
    "mpc.restart": {"mpc.solve"},
    "mpc.extract": {None},
    "b1.wrapper": {None, "mpc.solve", "mpc.tail", "mpc.restart"},
    "b2.setpoints": {"loop.replan"},
    "b2.wrapper": {"loop.replan"},
    "loop.prepare": {None},
    "loop.replan": {None},
    "loop.speed_cap": {"loop.replan"},
    "loop.margins": {"loop.replan"},
    "loop.sensing": {"loop.replan"},
    "loop.problem": {"loop.replan"},
    "loop.outcome": {None},
}
SOLVE_SPANS = ("mpc.make_problem", "mpc.solve", "mpc.cold_start", "mpc.finalize",
               "mpc.tail", "mpc.restart", "mpc.extract")
LOOP_SPANS = ("mpc.solve", "mpc.finalize", "b2.setpoints", "b2.wrapper", "loop.prepare",
              "loop.replan", "loop.speed_cap", "loop.margins", "loop.sensing",
              "loop.problem", "loop.outcome")
SOLVE_CFG = se3_mpc.SE3MPCConfig(max_iterations=2, cg_iterations=2, tail_iterations=2,
                                 tail_cg_iterations=2, restart_iterations=2)


@pytest.fixture
def fresh():
    """The global manager emptied: histories, counters and span counts."""
    get_metrics().reset()
    yield get_metrics()
    get_metrics().reset()


def _solve():
    rng = np.random.default_rng(0)
    prob = se3_mpc.make_problem(
        torch.tensor(rng.normal(0, 1, (6, 3)) + [0, 0, 3], dtype=torch.float32),
        torch.zeros(6, 3), torch.tensor([5.0, 0.0, 3.0]),
        obstacles=torch.tensor([[2.5, 0.0, 3.0, 0.5]]), config=SOLVE_CFG, device="cpu")
    res = se3_mpc.solve(SOLVE_CFG, prob)
    traj = se3_mpc.extract_trajectory(SOLVE_CFG, res, 0.0)
    return tuple(res) + (traj.attitudes, traj.body_rates, traj.thrusts, traj.timestamps)


def _episode():
    """Four episodes through the packed tick block's plain version, with
    every per-replan stage on: the speed cap, the goal clamp, sensing and
    noise."""
    mpc = se3_mpc.SE3MPCConfig(max_iterations=2, cg_iterations=2, tail_iterations=0,
                               goal_margin_clamp=0.5)
    cfg = closed_loop.ClosedLoopConfig(
        mpc=mpc, substeps_per_plan=4, num_replans=2, sensor_noise_std=0.02, wind_mean=1.0,
        wind_std=0.5, sense_radius=3.0, unknown_speed_cap=2.0)
    gen = torch.Generator().manual_seed(3)
    starts = torch.tensor([[0.0, 0.0, 2.0], [0.5, 0.0, 2.0], [0.0, 0.5, 2.5], [1.0, 1.0, 2.0]])
    states = DroneState.zeros((4,), dtype=torch.float32, device="cpu").replace(position=starts)
    goals = torch.tensor([[5.0, 0.0, 3.0]]).expand(4, 3)
    spheres = torch.tensor([[2.5, 0.0, 2.5, 0.5], [3.0, 1.0, 3.0, 0.4]])
    corridor = torch.linspace(1.0, 0.2, 8).expand(4, 8)
    res = closed_loop.simulate_episode(
        cfg, gen, states, goals, obstacles=spheres[:1], method="fused",
        true_obstacles=spheres, corridor_observed=corridor)
    return tuple(res)


def _names(events) -> list:
    return [e for e in events if e.name in PARENTS]


def _program_parent(event):
    p = event.cpu_parent
    while p is not None and p.name not in PARENTS:
        p = p.cpu_parent
    return None if p is None else p.name


def test_every_span_of_a_solve_and_an_episode_is_recorded(fresh):
    _solve()
    for name in SOLVE_SPANS:
        assert fresh.history(name), f"{name} was not recorded"
    fresh.reset()
    _episode()
    for name in LOOP_SPANS:
        assert fresh.history(name), f"{name} was not recorded"
    assert len(fresh.history("loop.replan")) == 2 and len(fresh.history("loop.prepare")) == 1
    assert all(ms >= 0.0 for ms in fresh.history("loop.replan"))
    # the operator's view: the stages' quantiles on /metrics
    text = fresh.prometheus_exposition()
    assert 'dart_mpc_solve{quantile="95"}' in text and "dart_loop_replan_count 2" in text


@pytest.fixture(scope="module")
def emulated_library(tmp_path_factory):
    return build_emulated_library(tmp_path_factory.mktemp("emulation"))


def test_b1_wrapper_is_recorded_through_the_emulated_library(fresh, emulated_library):
    config = se3_mpc.SE3MPCConfig(max_iterations=1, cg_iterations=2, tail_iterations=0)
    prob = se3_mpc.make_problem(torch.tensor([[0.0, 0.0, 2.0]] * 4), torch.zeros(4, 3),
                                torch.tensor([5.0, 0.0, 3.0]), config=config, device="cpu")
    u0 = se3_mpc.initialize_thrusts(config, prob)
    out = cuda_mpc.run_library(lambda: emulated_library, config, prob, u0, True, None)
    assert out[0].shape == (4, 20, 3)
    assert len(fresh.history("b1.wrapper")) == 1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cuda_mpc.run_library(lambda: emulated_library, config, prob, u0, True, None)
    assert [e.name for e in _names(prof.events())] == ["b1.wrapper"]
    assert fresh.span_counts()["calls"] == {"b1.wrapper": 1}
    assert len(fresh.history("b1.wrapper")) == 2


def _through_the_emulated_b1(monkeypatch, library):
    """``se3_mpc.solve`` on CPU tensors through the emulated kernel B1, as on
    the card: every pass's launch goes through ``run_library``."""
    def fused(config, prob, u_init, use_obstacles=True, solve_pass="phase1", with_grad=False):
        return cuda_mpc.run_library(lambda: library, config, prob, u_init, use_obstacles,
                                    None, solve_pass, with_grad)

    monkeypatch.setattr(se3_mpc, "resolve_method", lambda prob, method: "cuda")
    monkeypatch.setattr(cuda_mpc, "solve_thrusts_fused", fused)


@pytest.mark.parametrize("N,steps,per_warp", [(20, 1, 1), (100, 4, 1)])
def test_b1_launches_count_each_pass_of_a_two_phase_solve_at_its_arm(
        fresh, monkeypatch, emulated_library, N, steps, per_warp):
    """A two-phase solve launches B1 once in phase 1 and once in the tail:
    ``b1_launches`` rises by one under each pass, at N's steps a lane, the
    shared arena and the arm's scenarios a warp (one: four scenarios are
    within one wave of the emulated H100), on ``/metrics`` too; the wrapper's milliseconds go
    into ``b1.wrapper`` and ``b1.wrapper.<pass>`` alike. A warm replan
    (shifted warm start, solve, extraction) counts no sync under the
    profiler."""
    _through_the_emulated_b1(monkeypatch, emulated_library)
    config = se3_mpc.SE3MPCConfig(prediction_horizon=N, max_iterations=1, cg_iterations=2,
                                  gn_warmup_iterations=1, tail_iterations=1,
                                  tail_cg_iterations=2)
    prob = se3_mpc.make_problem(
        torch.tensor([[0.0, 0.0, 2.0], [0.5, 0.0, 2.5], [0.0, 0.5, 3.0], [1.0, 1.0, 2.0]]),
        torch.zeros(4, 3), torch.tensor([5.0, 0.0, 3.0]),
        obstacles=torch.tensor([[2.5, 0.0, 3.0, 0.5]]), config=config, device="cpu")
    res = se3_mpc.solve(config, prob)
    key = {p: (("arena", "shared"), ("pass", p), ("per_warp", str(per_warp)),
               ("steps", str(steps)))
           for p in ("phase1", "tail")}
    assert fresh.series("b1_launches") == {key["phase1"]: 1, key["tail"]: 1}
    assert fresh.history("b1.wrapper") == (fresh.history("b1.wrapper.phase1")
                                           + fresh.history("b1.wrapper.tail"))
    text = fresh.prometheus_exposition()
    assert ('dart_b1_launches_total{arena="shared",pass="tail",'
            f'per_warp="{per_warp}",steps="{steps}"}} 1' in text)
    with profile(activities=[ProfilerActivity.CPU]):
        warm = se3_mpc.solve(config, prob, se3_mpc.shift_warm_start(config, res.thrusts))
        se3_mpc.extract_trajectory(config, warm, 0.0)
    assert fresh.span_counts()["syncs"] == {}
    assert fresh.series("b1_launches") == {key["phase1"]: 2, key["tail"]: 2}


def test_no_profiler_range_without_the_profiler(fresh, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(metrics.MetricsManager, "_enter_traced", refuse)
    _solve()
    _episode()
    assert fresh.span_counts() == {"calls": {}, "syncs": {}}
    assert fresh.history("loop.replan") and fresh.history("mpc.tail")


def test_ranges_appear_under_the_profiler_and_nest_as_the_stages(fresh):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _solve()
        _episode()
    events = _names(prof.events())
    seen = {e.name for e in events}
    assert seen == set(SOLVE_SPANS) | set(LOOP_SPANS)
    for e in events:
        assert _program_parent(e) in PARENTS[e.name], (e.name, _program_parent(e))
    # the solve in the loop sits in its replan; the tail's finalize in the tail
    parents = {(e.name, _program_parent(e)) for e in events}
    assert ("mpc.solve", "loop.replan") in parents and ("mpc.finalize", "mpc.tail") in parents
    calls = fresh.span_counts()["calls"]
    assert calls == {name: sum(e.name == name for e in events) for name in seen}
    assert calls["loop.replan"] == 2 and calls["mpc.solve"] == 3


def test_outputs_are_bitwise_equal_with_tier_one_on_and_off(fresh):
    plain = _solve() + _episode()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _solve() + _episode()
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        if a is None:
            assert b is None
        else:
            assert torch.equal(a, b)


def test_syncs_count_to_the_innermost_span_and_the_filters_come_back(fresh):
    filters, shown = list(warnings.filters), warnings.showwarning
    with warnings.catch_warnings(record=True) as log:
        warnings.simplefilter("default")
        with profile(activities=[ProfilerActivity.CPU]):
            with span("t.outer"):
                warnings.warn(SYNC_MESSAGE)
                with span("t.inner"):
                    for _ in range(3):  # one place, every time: the filter is "always"
                        warnings.warn(SYNC_MESSAGE)
                warnings.warn("another warning")
            warnings.warn(SYNC_MESSAGE)  # outside any span: not counted
        with span("t.outer"):  # no profiler: not counted
            warnings.warn(SYNC_MESSAGE)
    assert fresh.span_counts() == {"calls": {"t.outer": 1, "t.inner": 1},
                                   "syncs": {"t.outer": 1, "t.inner": 3}}
    assert "another warning" in [str(w.message) for w in log]
    assert warnings.filters == filters and warnings.showwarning is shown
    assert len(fresh.history("t.outer")) == 2


@pytest.mark.parametrize("mode,inside", [(0, 1), (1, 1), (2, 2)],
                         ids=["off", "users-warn", "users-error"])
def test_the_sync_debug_mode_is_set_only_where_it_was_off(fresh, monkeypatch, mode, inside):
    """Where the process had no mode, tier 1 sets "warn" and keeps its own
    sync warnings; a mode the process set ("warn", "error") stays, and its
    warnings are still shown."""
    state = {"mode": mode}
    codes = {"default": 0, "warn": 1, "error": 2}
    seen = []
    with warnings.catch_warnings(record=True) as log:
        warnings.simplefilter("always")
        with profile(activities=[ProfilerActivity.CPU]):
            monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
            monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: state["mode"])
            monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                                lambda m: state.update(mode=codes.get(m, m)))
            with span("t.outer"):
                with span("t.inner"):
                    seen.append(state["mode"])
                    warnings.warn(SYNC_MESSAGE)
            seen.append(state["mode"])
            monkeypatch.undo()
    assert seen == [inside, mode]
    assert fresh.span_counts()["syncs"] == {"t.inner": 1}
    shown = [str(w.message) for w in log].count(SYNC_MESSAGE)
    assert shown == (0 if mode == 0 else 1)


def test_the_counts_only_rise(fresh):
    totals = []
    for stretch in range(3):
        with warnings.catch_warnings(record=True):
            with profile(activities=[ProfilerActivity.CPU]):
                for _ in range(stretch + 1):
                    with span("t.replan"):
                        warnings.warn(SYNC_MESSAGE)
                        warnings.warn(SYNC_MESSAGE)
        c = fresh.span_counts()
        totals.append((c["calls"]["t.replan"], c["syncs"]["t.replan"]))
    assert totals == [(1, 2), (3, 6), (6, 12)]


def test_a_span_on_a_function_opens_a_fresh_span_each_call(fresh):
    @span("t.stage")
    def stage(x, *, fail=False):
        """doc"""
        if fail:
            raise ValueError("stage failed")
        return x + 1

    assert stage.__name__ == "stage" and stage.__doc__ == "doc"
    assert stage(1) == 2 and stage(2) == 3
    with pytest.raises(ValueError, match="stage failed"):
        stage(0, fail=True)
    assert len(fresh.history("t.stage")) == 3
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("t.outer"):
            stage(0)
            stage(0)
    inner = [e for e in prof.events() if e.name == "t.stage"]
    assert len(inner) == 2 and all(e.cpu_parent.name == "t.outer" for e in inner)
    assert fresh.span_counts()["calls"] == {"t.outer": 1, "t.stage": 2}


def test_the_stage_trace_script_needs_a_card(monkeypatch, capsys):
    spec = importlib.util.spec_from_file_location(
        "trace_stages_torch", ROOT / "scripts" / "trace_stages_torch.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert script.main(["--workload", "mc16k-perceived", "--seed", "7"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "needs a CUDA card" in out.err


def test_device_trace_sums_up_the_spans_it_saw(fresh, tmp_path):
    fresh.record("t.stage", 1.0)
    with warnings.catch_warnings(record=True):
        with metrics.device_trace(str(tmp_path)) as seen:
            with span("t.stage"):
                warnings.warn(SYNC_MESSAGE)
                torch.ones(64).cumsum(0)
    assert seen.calls == {"t.stage": 1} and seen.syncs == {"t.stage": 1}
    assert seen.wall_s > 0.0
    if not torch.cuda.is_available():
        assert seen.busy_s is None and seen.idle_s == {}
    assert list(tmp_path.glob("*.pt.trace.json"))


def _reader(name: str):
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"trace_reader_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


READERS = ("syncs_per_replan.fleet", "syncs_per_replan.mc", "solve_host_ms.fleet",
           "solve_host_ms.mc", "b1_wrapper_ms.mc", "loop_stages_ms.mc")


@pytest.mark.parametrize("name", READERS)
def test_a_reader_of_the_spans_finds_nothing_in_an_empty_context(fresh, name):
    fresh.record("mpc.solve", 1.0)
    assert _reader(name).read({}) is None


def _fill(m, window: dict, traced: dict):
    """``window``: each span's window samples; ``traced``: each span's
    (calls, syncs a call) in a profiled stretch after them."""
    for name, values in window.items():
        for v in values:
            m.record(name, v)
    with warnings.catch_warnings(record=True):
        with profile(activities=[ProfilerActivity.CPU]):
            for name, (calls, syncs) in traced.items():
                for _ in range(calls):
                    with span(name):
                        for _ in range(syncs):
                            warnings.warn(SYNC_MESSAGE)


def test_the_fleet_readers_give_their_formulas(fresh):
    _fill(fresh, {"mpc.solve": [9.0, 2.0, 3.0, 4.0, 30.0]},
          {"mpc.solve": (4, 3), "mpc.finalize": (8, 1)})
    ctx = {"replans": 900, "replan_ms": 33.0, "profile": {"window_s": 0.5}}
    assert _reader("syncs_per_replan.fleet").read(ctx) == (4 * 3 + 8) / 4
    assert _reader("solve_host_ms.fleet").read(ctx) == 4.0
    assert _reader("syncs_per_replan.fleet").read({"replans": 900}) is None


def test_the_closed_loop_readers_give_their_formulas(fresh):
    window = {"mpc.solve": [6.0, 6.5, 7.0], "b1.wrapper": [0.4, 0.2, 0.3],
              "loop.speed_cap": [0.1, 0.2, 0.3], "loop.margins": [0.05, 0.05, 0.06],
              "loop.sensing": [0.1, 0.1, 0.1], "loop.problem": [0.2, 0.1, 0.3],
              "b2.setpoints": [0.3, 0.3, 0.4], "loop.prepare": [12.0, 14.0],
              "loop.outcome": [2.0, 4.0]}
    _fill(fresh, window, {"loop.replan": (60, 0), "mpc.solve": (60, 2), "loop.problem": (60, 1),
                          "b1.wrapper": (60, 0), "loop.prepare": (1, 5)})
    ctx = {"runs": 10, "replans": 600, "profile": {"window_s": 0.7}}
    assert _reader("syncs_per_replan.mc").read(ctx) == (60 * 2 + 60 + 5) / 60
    assert _reader("solve_host_ms.mc").read(ctx) == 6.5
    assert _reader("b1_wrapper_ms.mc").read(ctx) == 0.3
    med = {k: statistics.median(v) for k, v in window.items()}
    want = (med["loop.speed_cap"] + med["loop.margins"] + med["loop.sensing"]
            + med["loop.problem"] + med["b2.setpoints"]
            + (med["loop.prepare"] + med["loop.outcome"]) / 60)
    assert _reader("loop_stages_ms.mc").read(ctx) == pytest.approx(want, rel=1e-12)


@pytest.mark.cuda
def test_one_pageable_upload_in_a_span_counts_one_sync_on_the_card(fresh):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sync debug mode watches CUDA syncs")
    torch.cuda.init()
    mode = torch.cuda.get_sync_debug_mode()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with span("t.upload"):
            torch.tensor([1.0], device="cuda")
        with span("t.launch"):
            torch.ones(8, device="cuda").add_(1.0)  # a launch, no sync
    assert fresh.span_counts()["syncs"] == {"t.upload": 1}
    assert torch.cuda.get_sync_debug_mode() == mode


def _uploads() -> int:
    return get_metrics().all_summaries()["counters"].get("device_constant_uploads", 0)


@pytest.mark.cuda
def test_a_warm_replan_and_episode_make_no_sync_on_the_card(fresh):
    """Once warm, a two-phase solve at B=4096 with spheres, warm-started, its
    extraction and a 3-replan episode through B1 and B2 with given wind and
    noise run under sync debug mode "error" without raising, and make no
    device constant: every constant of the solve and the loop was made on
    the card once, before. ``"cuda"`` and ``"cuda:0"`` name one entry."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernels B1 and B2 and the sync debug mode")
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(20)
    B, cfg = 4096, se3_mpc.SE3MPCConfig()
    obs = np.concatenate([rng.normal(0, 3, (B, 4, 3)) + [5, 0, 3],
                          rng.uniform(0.3, 1.0, (B, 4, 1))], -1)
    p0 = rng.normal(0, 1, (B, 3)) + [0, 0, 3]
    goal = rng.normal(0, 1, (B, 3)) + [10, 0, 3]
    v0, stamps = rng.normal(0, 0.5, (B, 3)), rng.uniform(0, 5, B)
    obs, p0, goal, v0, stamps = (torch.tensor(x, dtype=torch.float32, device=dev)
                                 for x in (obs, p0, goal, v0, stamps))
    loop_cfg = closed_loop.ClosedLoopConfig(num_replans=3, sense_radius=3.0,
                                            unknown_speed_cap=2.0)
    state0 = DroneState.zeros((B,), device=dev).replace(position=p0)
    wind = torch.tensor(rng.normal(1.0, 0.5, (B, 3)), dtype=torch.float32, device=dev)
    noise = torch.tensor(rng.normal(0, 0.02, (3, B, 6)), dtype=torch.float32, device=dev)
    corridor = torch.tensor(rng.uniform(0, 1, (B, 16)), dtype=torch.float32, device=dev)

    def replan(u_prev):
        prob = se3_mpc.make_problem(p0, v0, goal, obstacles=obs, config=cfg)
        res = se3_mpc.solve(cfg, prob, se3_mpc.shift_warm_start(cfg, u_prev))
        traj = se3_mpc.extract_trajectory(cfg, res, stamps)
        ep = closed_loop.simulate_episode(
            loop_cfg, None, state0, goal, obstacles=obs[0], method="auto",
            true_obstacles=obs[0, :, :], corridor_observed=corridor, wind=wind,
            noise=noise)
        return res, traj, ep

    cold = se3_mpc.solve(cfg, se3_mpc.make_problem(p0, v0, goal, obstacles=obs, config=cfg))
    replan(cold.thrusts)  # warm: the libraries, the allocator, every constant
    torch.cuda.synchronize()
    launches = cuda_mpc.LAUNCHES
    uploads = _uploads()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res, traj, ep = replan(cold.thrusts)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    assert _uploads() == uploads
    assert cuda_mpc.LAUNCHES == launches + 2 + loop_cfg.num_replans
    for x in (res.thrusts, res.cost, traj.attitudes, ep.final_position):
        assert bool(torch.isfinite(x).all())
    g = se3_mpc._gravity(cfg, torch.float32, "cuda")
    assert se3_mpc._gravity(cfg, torch.float32, f"cuda:{dev.index}") is g
    for a, b in zip(cfg.thrust_bounds(device="cuda"),
                    cfg.thrust_bounds(device=f"cuda:{dev.index}")):
        assert a is b
    assert _uploads() == uploads


@pytest.mark.cuda
@pytest.mark.parametrize("N,steps,per_warp", [(20, 1, (4, 1)), (100, 4, (1, 1))])
def test_b1_launches_on_the_card_count_each_pass_without_a_sync(fresh, N, steps, per_warp):
    """On the card, a warm two-phase solve at B=4096 under sync debug mode
    "error" raises nothing and adds one phase-1 and one tail launch to
    ``b1_launches``, at N's steps a lane in shared memory and the arm's
    scenarios a warp (at N=20 phase 1's 4096 are packed four a warp, the
    tail's 1024 are within one wave of one a warp)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel B1 and the sync debug mode")
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(21)
    B, cfg = 4096, se3_mpc.SE3MPCConfig(prediction_horizon=N)
    obs = np.concatenate([rng.normal(0, 3, (B, 4, 3)) + [5, 0, 3],
                          rng.uniform(0.3, 1.0, (B, 4, 1))], -1)
    p0, v0 = rng.normal(0, 1, (B, 3)) + [0, 0, 3], rng.normal(0, 0.5, (B, 3))
    goal = rng.normal(0, 1, (B, 3)) + [10, 0, 3]
    obs, p0, v0, goal = (torch.tensor(x, dtype=torch.float32, device=dev)
                         for x in (obs, p0, v0, goal))
    prob = se3_mpc.make_problem(p0, v0, goal, obstacles=obs, config=cfg)
    cold = se3_mpc.solve(cfg, prob)
    se3_mpc.solve(cfg, prob, se3_mpc.shift_warm_start(cfg, cold.thrusts))  # warm
    torch.cuda.synchronize()
    before = fresh.series("b1_launches")
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = se3_mpc.solve(cfg, prob, se3_mpc.shift_warm_start(cfg, cold.thrusts))
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    after = fresh.series("b1_launches")
    rose = {dict(k)["pass"]: (dict(k)["steps"], dict(k)["arena"], dict(k)["per_warp"],
                              n - before.get(k, 0))
            for k, n in after.items() if n > before.get(k, 0)}
    assert rose == {p: (str(steps), "shared", str(w), 1)
                    for p, w in zip(("phase1", "tail"), per_warp)}
    assert bool(torch.isfinite(res.cost).all())
