"""The port's runtime support modules on the CPU, against the JAX package:
``common/units.py``, ``common/state_buffer.py``, ``common/error_recovery.py``,
``common/di.py``, ``hardware/safety.py`` (``SafetyManager``),
``hardware/latency_buffer.py`` and ``hardware/safety_watchdog.py``.

The cases of tests/test_runtime_common.py (state buffer),
tests/test_estimation_recovery.py (retry, circuit breaker, degradation),
tests/test_security_di.py (the DI cases) and tests/test_hardware.py (the
latency buffer, the safety manager) run against the port. Beside them, each
module is held against the JAX package on the same inputs: unit
conversions to float64 rounding (rtol 1e-12), the rest exactly (versions,
states, messages, counters). The watchdog runs on the wall clock (a 50 ms
timeout polled every 10 ms) and is asserted on counts only.
"""

import asyncio
import threading
import time

import numpy as np
import pytest
import torch

from dart_planner_tpu.common import units as J_units
from dart_planner_tpu.common.error_recovery import CircuitBreaker as JCircuitBreaker
from dart_planner_tpu.common.state_buffer import ThreadSafeStateBuffer as JBuffer
from dart_planner_tpu.common.types import DroneState as JDroneState
from dart_planner_tpu.hardware import LatencyBuffer as JLatencyBuffer
from dart_planner_tpu.hardware import SafetyLimits as JSafetyLimits
from dart_planner_tpu.hardware import SafetyManager as JSafetyManager
from dart_planner_tpu.hardware import SafetyWatchdog as JSafetyWatchdog
from dart_planner_tpu_torch.common import units
from dart_planner_tpu_torch.common.di import DIContainer, Stage, create_default_container
from dart_planner_tpu_torch.common.error_recovery import (
    CircuitBreaker,
    CircuitBreakerOpenError,
    CircuitState,
    GracefulDegradation,
    RetryConfig,
    retry_with_backoff,
)
from dart_planner_tpu_torch.common.errors import DependencyError
from dart_planner_tpu_torch.common.state_buffer import (
    DroneStateBuffer,
    StateManager,
    ThreadSafeStateBuffer,
)
from dart_planner_tpu_torch.common.types import (
    Accel,
    DroneState,
    EstimatedState,
    Pose,
    Twist,
)
from dart_planner_tpu_torch.comms.heartbeat import HeartbeatConfig
from dart_planner_tpu_torch.hardware import (
    LatencyBuffer,
    SafetyLimits,
    SafetyManager,
    SafetyWatchdog,
    VehicleIOFactory,
)


def _state(**kw):
    return DroneState.create(device="cpu", **kw)


# ---- units ----
@pytest.mark.parametrize("value, unit, si", [
    (2.5, "km", "m"), ([1.0, 2.0, 3.0], "cm", "m"), (90.0, "deg", "rad"),
    ([36.0, 72.0], "km/h", "m/s"), (1.5, "g", "m/s^2"), (3.0, "m", "m"),
    (250.0, "us", "s"), (2.0, "kgf", "N"),
])
def test_to_si_matches_jax(value, unit, si):
    t = units.to_si(value, unit, si)
    np.testing.assert_allclose(t, J_units.to_si(value, unit, si), rtol=1e-12)
    tt = units.to_si(torch.tensor(value, dtype=torch.float64), unit, si)
    assert not isinstance(tt, torch.Tensor) and np.asarray(tt).dtype == np.float64
    np.testing.assert_allclose(tt, t, rtol=1e-12)


def test_unit_errors_match_jax():
    with pytest.raises(units.UnitError):
        units.to_si(1.0, "furlong", "m")
    with pytest.raises(J_units.UnitError):
        J_units.to_si(1.0, "furlong", "m")
    for value, kind in (([0.0, np.inf, 1.0], "position"), ([1.0, 2.0], "velocity"),
                        (1.0, "torque"), ([1.0, 2.0, 3.0], "colour")):
        with pytest.raises(units.UnitError):
            units.ensure_si(value, kind)
        with pytest.raises(units.UnitError):
            units.ensure_si(torch.tensor(value), kind)
        with pytest.raises(J_units.UnitError):
            J_units.ensure_si(value, kind)
    ok = units.ensure_si(torch.tensor([[1.0, 2.0, 3.0]]), "velocity")
    assert ok.dtype == np.float64 and ok.shape == (1, 3)
    np.testing.assert_array_equal(ok, J_units.ensure_si([[1.0, 2.0, 3.0]], "velocity"))
    assert units.SI_UNITS == J_units.SI_UNITS


# ---- state buffer (tests/test_runtime_common.py) ----
def test_buffer_versioning_and_latest():
    buf = ThreadSafeStateBuffer(buffer_size=4, state_type=dict)
    assert buf.get_latest_state() is None
    for i in range(10):
        v = buf.update_state({"i": i}, timestamp=float(i))
        assert v == i + 1
    snap = buf.get_latest_state()
    assert snap.state["i"] == 9
    assert snap.version == 10


def test_buffer_at_time_query():
    buf = ThreadSafeStateBuffer(buffer_size=8, state_type=dict)
    for i in range(8):
        buf.update_state({"i": i}, timestamp=float(i))
    snap = buf.get_state_at_time(5.04, tolerance=0.1)
    assert snap is not None and snap.state["i"] == 5
    assert buf.get_state_at_time(100.0, tolerance=0.1) is None


def test_buffer_threaded_producers():
    buf = ThreadSafeStateBuffer(buffer_size=16, state_type=int)

    def produce(k):
        for i in range(100):
            buf.update_state(k * 1000 + i)

    threads = [threading.Thread(target=produce, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert buf.get_latest_state().version == 400
    assert buf.get_statistics()["updates"] == 400


def test_drone_state_buffer_and_manager():
    mgr = StateManager()
    buf = DroneStateBuffer()
    mgr.register_buffer("drone", buf)
    mgr.update_state("drone", _state(position=(1, 2, 3)))
    snap = mgr.get_latest_state("drone")
    np.testing.assert_allclose(snap.state.position.numpy(), [1, 2, 3])
    assert "drone" in mgr.get_all_statistics()


def test_buffer_matches_jax_and_keeps_states_by_reference():
    """The same updates and queries through both buffers: the same versions,
    snapshots and statistics; the port's tensors are stored, not copied."""
    tb, jb = ThreadSafeStateBuffer(buffer_size=5), JBuffer(buffer_size=5)
    states = [_state(timestamp=0.1 * i, position=(i, 0.0, 2.0)) for i in range(12)]
    for i, st in enumerate(states):
        assert tb.update_state(st, source="sim", timestamp=0.1 * i) == jb.update_state(
            JDroneState.create(timestamp=0.1 * i, position=(i, 0.0, 2.0)),
            source="sim", timestamp=0.1 * i)
    assert tb.get_latest_state().state is states[-1]
    assert jb.get_latest_state().version == 12
    for t in (0.0, 0.74, 0.81, 1.1, 2.0):
        ts, js = tb.get_state_at_time(t, 0.05), jb.get_state_at_time(t, 0.05)
        assert (ts is None) == (js is None)
        if ts is not None:
            assert (ts.version, ts.timestamp, ts.source) == (js.version, js.timestamp, js.source)
            np.testing.assert_array_equal(ts.state.position.numpy(),
                                          np.asarray(js.state.position))
    assert tb.get_statistics() == jb.get_statistics()
    est = EstimatedState(
        timestamp=torch.tensor(3.5), pose=Pose(torch.tensor([1.0, 2.0, 3.0]), torch.zeros(3)),
        twist=Twist(torch.tensor([0.5, 0.0, 0.0]), torch.zeros(3)),
        accel=Accel(torch.zeros(3), torch.zeros(3)))
    dbuf = DroneStateBuffer()
    assert dbuf.update_from_estimator(est) == 1
    snap = dbuf.get_latest_state()
    assert (snap.timestamp, snap.source) == (3.5, "estimator")
    assert snap.state.position is est.pose.position


# ---- retry / circuit breaker (tests/test_estimation_recovery.py) ----
def test_retry_eventually_succeeds():
    calls = {"n": 0}

    @retry_with_backoff(RetryConfig(max_attempts=4, base_delay=0.001))
    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise ValueError("boom")
        return "ok"

    assert flaky() == "ok"
    assert calls["n"] == 3


def test_retry_raises_after_exhaustion():
    @retry_with_backoff(RetryConfig(max_attempts=2, base_delay=0.001))
    def always_fails():
        raise ValueError("nope")

    with pytest.raises(ValueError):
        always_fails()


def test_circuit_breaker_opens_and_recovers():
    cb = CircuitBreaker(failure_threshold=2, recovery_timeout=0.05)

    def fail():
        raise RuntimeError("down")

    for _ in range(2):
        with pytest.raises(RuntimeError):
            cb.call(fail)
    assert cb.state is CircuitState.OPEN
    with pytest.raises(CircuitBreakerOpenError):
        cb.call(lambda: "hi")
    time.sleep(0.06)  # recovery window
    assert cb.call(lambda: "hi") == "hi"  # half-open probe succeeds
    assert cb.state is CircuitState.CLOSED


def test_graceful_degradation_fallback():
    gd = GracefulDegradation()
    gd.register_fallback("plan", lambda: "hover")
    assert gd.execute("plan", lambda: "trajectory") == "trajectory"

    def broken():
        raise RuntimeError("solver died")

    assert gd.execute("plan", broken) == "hover"
    with pytest.raises(RuntimeError):
        gd.execute("other", broken)


def test_async_retry_and_breaker_states_match_jax():
    calls = {"n": 0}

    @retry_with_backoff(RetryConfig(max_attempts=3, base_delay=0.001))
    async def flaky():
        calls["n"] += 1
        if calls["n"] < 2:
            raise ConnectionError("link")
        return calls["n"]

    assert asyncio.run(flaky()) == 2
    tb, jb = CircuitBreaker(failure_threshold=3), JCircuitBreaker(failure_threshold=3)
    for outcome in (True, False, False, True, False, False, False, True):
        for cb in (tb, jb):
            try:
                cb.call(lambda: None) if outcome else cb.call(lambda: 1 / 0)
            except Exception:
                pass
        assert (tb.state.value, tb.failure_count) == (jb.state.value, jb.failure_count)
    assert tb.state is CircuitState.OPEN


# ---- DI (tests/test_security_di.py) ----
def test_di_singleton_and_factory():
    c = DIContainer()
    c.register_singleton(dict, lambda _: {"n": 0})
    c.register_factory(list, lambda _: [])
    a, b = c.resolve(dict), c.resolve(dict)
    assert a is b
    assert c.resolve(list) is not c.resolve(list)
    with pytest.raises(DependencyError):
        c.resolve(set)


def test_di_cycle_detection():
    class A: ...

    class B: ...

    c = DIContainer()
    c.register_singleton(A, lambda cc: A(), depends_on=(B,))
    c.register_singleton(B, lambda cc: B(), depends_on=(A,))
    assert c.detect_cycles()
    with pytest.raises(DependencyError):
        c.dependency_order()


def test_default_container_wires_stack():
    from dart_planner_tpu_torch.planning.se3_mpc import SE3MPCPlanner

    c = create_default_container(device="cpu")
    planner = c.resolve(SE3MPCPlanner)
    assert planner.config.prediction_horizon == 20
    assert planner is c.resolve(SE3MPCPlanner)
    order = c.dependency_order()
    assert order.index(type(c.resolve(SE3MPCPlanner))) >= 0


def test_default_container_puts_the_stack_on_one_device():
    from dart_planner_tpu_torch.config.frozen_config import DARTPlannerFrozenConfig
    from dart_planner_tpu_torch.control.geometric import GeometricController
    from dart_planner_tpu_torch.control.smoother import TrajectorySmoother
    from dart_planner_tpu_torch.perception.mapper import GeometricMapper
    from dart_planner_tpu_torch.planning.global_mission import GlobalMissionPlanner
    from dart_planner_tpu_torch.planning.se3_mpc import SE3MPCPlanner

    c = create_default_container(device="cpu")
    for cls in (SE3MPCPlanner, GeometricController, TrajectorySmoother, GeometricMapper):
        assert c.resolve(cls).device == torch.device("cpu"), cls
    assert isinstance(c.resolve(GlobalMissionPlanner), GlobalMissionPlanner)
    assert c.dependency_order().index(DARTPlannerFrozenConfig) < \
        c.dependency_order().index(SE3MPCPlanner)
    with pytest.raises(DependencyError):  # the bootstrap stage is frozen
        c.register_singleton(float, lambda _: 1.0, stage=Stage.BOOTSTRAP)


# ---- latency buffer, safety manager (tests/test_hardware.py) ----
def test_latency_buffer_delay():
    buf = LatencyBuffer(delay_s=0.05, dt=0.01)
    outs = [buf.push(i, timestamp=i * 0.01) for i in range(20)]
    # first 5 pushes echo input; afterwards output lags input by 5 samples
    assert outs[:5] == [0, 1, 2, 3, 4]
    assert outs[10] == 5 and outs[19] == 14
    assert buf.is_ready()
    assert buf.get_statistics()["actual_delay_s"] == pytest.approx(0.05)


def test_latency_buffer_matches_jax():
    """The hardware.yaml transport delay (25 ms at a 5 ms loop): both
    buffers give the same outputs and statistics; tensors pass by reference."""
    tb, jb = LatencyBuffer(0.025, 0.005, 3), JLatencyBuffer(0.025, 0.005, 3)
    items = [torch.full((3,), float(i)) for i in range(9)]
    for i, x in enumerate(items):
        out = tb.push(x, timestamp=0.005 * i)
        assert out is items[i - 3 if i >= 3 else i]
        assert jb.push(i, timestamp=0.005 * i) == int(out[0])
    assert tb.get_statistics() == jb.get_statistics()
    tb.reset()
    assert not tb.is_ready() and tb.get_delayed_data() is None


def test_safety_manager_catches_slow_unsafe_climb():
    """A climb toward an unsafe goal passes per-plan checks but the state
    monitor catches the breach (reference safety.py behavior)."""

    async def main():
        v = VehicleIOFactory.create("simulated", {"device": "cpu"})
        await v.connect()
        await v.arm()
        sm = SafetyManager(SafetyLimits(max_altitude=50.0))
        # simulate states climbing past the ceiling
        for z in (10.0, 30.0, 49.0, 51.0, 55.0):
            ok = await sm.monitor_safety(_state(position=(0.0, 0.0, z)), v)
        return sm, ok

    sm, ok = asyncio.run(main())
    assert not ok
    assert sm.get_safety_violations() == 2  # 51 and 55
    assert "altitude" in sm.last_violation


def test_safety_manager_velocity_envelope():
    sm = SafetyManager()
    bad = _state(velocity=(20.0, 0.0, 0.0))
    assert sm.check_state(bad) is not None
    assert "speed" in sm.check_state(bad)


@pytest.mark.parametrize("position, velocity", [
    ((0.0, 0.0, 10.0), (1.0, 2.0, 0.5)),
    ((0.0, 0.0, 57.25), (0.0, 0.0, 0.0)),
    ((70.0, 80.0, 5.0), (0.0, 0.0, 0.0)),
    ((3.0, 4.0, 5.0), (12.0, 9.0, 3.0)),
    ((float("nan"), 0.0, 5.0), (0.0, 0.0, 0.0)),
    ((0.0, 0.0, float("inf")), (0.0, 0.0, 0.0)),
])
def test_safety_manager_matches_jax(position, velocity):
    limits = dict(max_altitude=40.0, safety_radius=90.0, max_velocity=14.0)
    tm = SafetyManager(SafetyLimits(**limits))
    jm = JSafetyManager(JSafetyLimits(**limits))
    t = tm.check_state(_state(position=position, velocity=velocity))
    j = jm.check_state(JDroneState.create(position=position, velocity=velocity))
    assert t == j


# ---- safety watchdog ----
class _Vehicle:
    def __init__(self):
        self.stops = 0

    async def emergency_stop(self):
        self.stops += 1


def _watch(cls, heartbeats: int):
    """Feeds the watchdog ``heartbeats`` times at 10 ms, then goes quiet
    for 150 ms (three 50 ms timeouts): (emergencies, stops, status)."""

    async def main():
        v = _Vehicle()
        wd = cls(v, cfg(interval_ms=10, timeout_ms=50))
        wd.start()
        for _ in range(heartbeats):
            wd.heartbeat()
            await asyncio.sleep(0.01)
        await asyncio.sleep(0.15)
        wd.stop()
        await asyncio.sleep(0)
        return wd.emergency_count, v.stops, wd.get_status()

    from dart_planner_tpu.comms.heartbeat import HeartbeatConfig as JHeartbeatConfig

    cfg = HeartbeatConfig if cls is SafetyWatchdog else JHeartbeatConfig
    return asyncio.run(main())


def test_watchdog_lands_on_heartbeat_loss_like_jax():
    for cls in (SafetyWatchdog, JSafetyWatchdog):
        emergencies, stops, status = _watch(cls, heartbeats=5)
        # one emergency a loss: the monitor latches until a heartbeat returns
        assert (emergencies, stops) == (1, 1), cls
        assert status["emergency_triggered"] and status["emergency_count"] == 1
        assert status["timeout_ms"] == 50
    t, j = _watch(SafetyWatchdog, 0)[2], _watch(JSafetyWatchdog, 0)[2]
    assert set(t) == set(j)
