"""The port's copies of the vehicle side's support modules against the JAX
package on the same inputs: ``common/pid.py`` and ``control/onboard.py``
(the legacy cascaded-PID controller, over the port's types),
``hardware/motor_model.py`` and ``hardware/motor_mixer.py``,
``security/validation.py`` (with tensors on the port's side),
``runtime/scheduler.py`` and ``runtime/integration.py``, and
``common/logging_config.py``.

The numpy modules compute in float64 on both sides and are compared
exactly; the onboard controller's command is float32 on both sides
(exact); the validators must accept and reject the same inputs with the
same messages. The scheduler's accounting is driven with a fake clock, so
nothing here depends on the wall clock.
"""

import asyncio
import logging

import numpy as np
import pytest
import torch

from dart_planner_tpu.common import logging_config as J_log
from dart_planner_tpu.common.errors import ValidationError as JValidationError
from dart_planner_tpu.common.pid import VectorPID as JPID
from dart_planner_tpu.common.types import DroneState as JDroneState
from dart_planner_tpu.common.types import Trajectory as JTrajectory
from dart_planner_tpu.control.onboard import OnboardController as JOnboard
from dart_planner_tpu.hardware import motor_mixer as J_mixer
from dart_planner_tpu.hardware import motor_model as J_model
from dart_planner_tpu.runtime import integration as J_integ
from dart_planner_tpu.runtime import scheduler as J_sched
from dart_planner_tpu.security import validation as J_val
from dart_planner_tpu_torch import DroneState, Trajectory
from dart_planner_tpu_torch.common import logging_config as T_log
from dart_planner_tpu_torch.common.errors import ValidationError
from dart_planner_tpu_torch.common.pid import VectorPID
from dart_planner_tpu_torch.control.onboard import OnboardController
from dart_planner_tpu_torch.hardware import motor_mixer as T_mixer
from dart_planner_tpu_torch.hardware import motor_model as T_model
from dart_planner_tpu_torch.runtime import integration as T_integ
from dart_planner_tpu_torch.runtime import scheduler as T_sched
from dart_planner_tpu_torch.security import validation as T_val


def test_vector_pid_matches_jax():
    rng = np.random.default_rng(0)
    kw = dict(kp=[2.0, 1.5, 3.0], ki=[1.0, 0.5, 0.2], kd=[0.3, 0.1, 0.0],
              integral_limit=0.5)
    j, t = JPID(**kw), VectorPID(**kw)
    for k in range(50):
        sp = rng.normal(0, 1, 3)
        j.setpoint = t.setpoint = sp
        meas, dt = rng.normal(0, 1, 3), float(rng.uniform(0.0, 0.05)) * (k % 7 != 3)
        np.testing.assert_array_equal(t.update(meas, dt), j.update(meas, dt))
    np.testing.assert_array_equal(t._integral, j._integral)


def _plans(rng, n=12):
    ts = np.arange(n) * 0.1
    pos = np.cumsum(rng.normal(0, 0.2, (n, 3)), 0) + [0.0, 0.0, 2.0]
    vel = rng.normal(0, 0.5, (n, 3))
    acc = rng.normal(0, 0.5, (n, 3))
    arrs = (ts, pos.astype(np.float32), vel.astype(np.float32), acc.astype(np.float32))
    return JTrajectory(*arrs), Trajectory(*[torch.as_tensor(a) for a in arrs])


def test_onboard_controller_matches_jax():
    """sense -> plan -> act over a random plan and a moving state, with a
    repeated timestamp (the hover fallback) on the way: the same command
    each step."""
    rng = np.random.default_rng(1)
    jplan, tplan = _plans(rng)
    j, t = JOnboard(mass=1.3), OnboardController(mass=1.3)
    for k, now in enumerate([0.0, 0.01, 0.02, 0.02, 0.05, 0.31, 0.9, 5.0]):
        pos, vel = rng.normal(0, 0.3, 3) + [0, 0, 2], rng.normal(0, 0.3, 3)
        att, rates = rng.normal(0, 0.1, 3), rng.normal(0, 0.2, 3)
        js = JDroneState.create(timestamp=now, position=pos, velocity=vel, attitude=att,
                                angular_velocity=rates)
        ts = DroneState.create(timestamp=now, position=pos, velocity=vel, attitude=att,
                               angular_velocity=rates, device="cpu")
        jcmd, jtarget = j.compute_control_command(js, jplan)
        tcmd, ttarget = t.compute_control_command(ts, tplan)
        np.testing.assert_array_equal(ttarget, jtarget)
        assert tcmd.thrust.item() == float(np.asarray(jcmd.thrust)), k
        np.testing.assert_array_equal(tcmd.torque.numpy(), np.asarray(jcmd.torque))
    assert tcmd.thrust.dtype == torch.float32 and tcmd.torque.device.type == "cpu"
    np.testing.assert_array_equal(t.get_fallback_command(ts).torque.numpy(), 0.0)


def test_motor_model_and_mixer_match_jax():
    rng = np.random.default_rng(2)
    bench = [dict(pwm_values=np.linspace(0.05, 1.0, 8),
                  thrust_values=12.0 * np.linspace(0.05, 1.0, 8) ** 1.7 + rng.normal(0, 0.05, 8),
                  motor_id=i) for i in range(4)]
    jm = J_model.fit_quadratic_motor_model([J_model.BenchTestData(**b) for b in bench])
    tm = T_model.fit_quadratic_motor_model([T_model.BenchTestData(**b) for b in bench])
    pwm = rng.uniform(0, 1, (16, 4))
    np.testing.assert_array_equal(tm.thrust_from_pwm(pwm), jm.thrust_from_pwm(pwm))
    thrust = rng.uniform(0, 12, (16, 4))
    np.testing.assert_array_equal(tm.pwm_from_thrust(thrust), jm.pwm_from_thrust(thrust))
    for make in ("create_x_configuration", "create_plus_configuration"):
        jmix = J_mixer.MotorMixer(getattr(J_mixer, make)(0.2))
        tmix = T_mixer.MotorMixer(getattr(T_mixer, make)(0.2))
        for _ in range(20):
            wrench = rng.normal(0, 1, 4) * [10.0, 1.0, 1.0, 0.2] + [40.0, 0, 0, 0]
            np.testing.assert_array_equal(tmix.mix_commands(wrench[0], wrench[1:]),
                                          jmix.mix_commands(wrench[0], wrench[1:]))
        assert tmix.get_status() == jmix.get_status()
        assert tmix.validate_configuration() == jmix.validate_configuration()
        w = rng.normal(0, 1, (5, 3))
        np.testing.assert_array_equal(tmix.allocate_batch(np.full(5, 10.0), w),
                                      jmix.allocate_batch(np.full(5, 10.0), w))
    assert tmix.saturation_events > 0  # the draws reach the saturation branch


def _trajectory(case):
    n, dt = 20, 0.1
    ts = np.arange(n) * dt
    vel = np.zeros((n, 3))
    vel[:, 0] = 1.0
    pos = np.zeros((n, 3))
    pos[:, 0] = ts
    pos[:, 2] = 2.0
    if case == "jump":
        pos[10:, 0] += 3.0
    elif case == "overspeed":
        vel[:, 0] = 40.0
        pos[:, 0] = ts * 40.0
    elif case == "high":
        pos[:, 2] = 900.0
    elif case == "nonmonotone":
        ts[5] = ts[4]
    elif case == "nan":
        pos[3, 1] = np.nan
    return ts, pos, vel, np.zeros((n, 3))


def _outcome(fn, *args, **kw):
    try:
        out = fn(*args, **kw)
    except (ValidationError, JValidationError) as e:
        return ("rejected", str(e))
    return ("ok", out)


@pytest.mark.parametrize("case", ["good", "jump", "overspeed", "high", "nonmonotone", "nan"])
def test_trajectory_validation_matches_jax(case):
    """The port's validator takes the plan's tensors (on any device) where
    the JAX one takes arrays: the same verdicts and messages."""
    arrs = _trajectory(case)
    j = _outcome(J_val.validate_trajectory, *arrs)
    t = _outcome(T_val.validate_trajectory, *[torch.as_tensor(a) for a in arrs])
    assert t[0] == j[0] and (t[0] == "ok" or t[1] == j[1]), (t, j)


def test_waypoint_and_command_validation_match_jax():
    for wps in ([(1.0, 2.0, 3.0), {"position": [4.0, 5.0, 6.0]}], [], [(1.0, np.nan, 2.0)],
                [(1e6, 0.0, 0.0)], [(1.0, 2.0)]):
        j, t = _outcome(J_val.validate_waypoints, wps), _outcome(T_val.validate_waypoints, wps)
        assert t[0] == j[0]
        if t[0] == "ok":
            np.testing.assert_array_equal(np.stack(t[1]), np.stack(j[1]))
        else:
            assert t[1] == j[1]
    for thrust, torque in ((10.0, [0.1, 0.0, 0.0]), (-1.0, [0.0, 0.0, 0.0]),
                           (5.0, [100.0, 0.0, 0.0])):
        j = _outcome(J_val.validate_command_envelope, thrust, torque)
        t = _outcome(T_val.validate_command_envelope, torch.tensor(thrust),
                     torch.tensor(torque))
        assert t[0] == j[0] and (t[0] == "ok" or t[1] == j[1]), (t, j)


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _drive(sched, integ, clock):
    """Three periodic tasks on ``integ.RealTimeManager``, dispatched by the
    scheduler on ``clock`` for 60 decisions: the dispatch order and the
    per-task stats."""
    order = []

    def body(name, cost):
        def run():
            order.append(name)
            clock.t += cost
        return run

    manager = integ.RealTimeManager()
    manager.set_control_function(body("control", 0.003), frequency_hz=400.0)  # overruns
    manager.set_planning_function(body("planning", 0.001), frequency_hz=50.0)
    manager.add_custom_task(sched.QuarticTask("telemetry", body("telemetry", 0.0), 10.0,
                                              priority=sched.TaskPriority.LOW))
    s = manager.scheduler

    async def run():
        for _ in range(60):
            now = clock()
            task = s._find_next_task(now)
            if task is None:
                clock.t = min(t.next_execution for t in s.tasks.values() if t.enabled)
                continue
            await s._execute_task(task, now)

    asyncio.run(run())
    return order, manager.get_stats()


def test_scheduler_accounting_and_integration_match_jax(monkeypatch):
    """The same periodic tasks, run by each package's ``RealTimeManager``
    on a fake clock: the same dispatch order and the same overrun,
    deadline and auto-disable accounting; the port also counts each
    task's overruns."""
    clock = _Clock()
    monkeypatch.setattr(J_sched.time, "perf_counter", clock)  # the one time module
    assert T_sched.time is J_sched.time
    j_order, j_stats = _drive(J_sched, J_integ, clock)
    clock.t = 100.0
    t_order, t_stats = _drive(T_sched, T_integ, clock)
    assert t_order == j_order
    assert t_stats["global"] == j_stats["global"]
    for name, st in t_stats["tasks"].items():
        assert {k: v for k, v in st.items() if k != "overruns"} == j_stats["tasks"][name]
    ctl = t_stats["tasks"]["control"]
    # control overran its 2.5 ms period 10 times in a row and was disabled
    assert not ctl["enabled"] and ctl["execution_count"] == 10 and ctl["overruns"] == 10
    assert t_stats["global"]["total_overruns"] == 10
    assert t_stats["tasks"]["planning"]["overruns"] == 0


def test_logging_is_configured_per_package():
    T_log.setup_logging()
    logger = T_log.get_logger("hardware.mission")
    assert logger.name == "dart_planner_tpu_torch.hardware.mission"
    root = logging.getLogger("dart_planner_tpu_torch")
    assert root.handlers and not root.propagate
    J_log.setup_logging()
    assert J_log.get_logger("x").name == "dart_planner_tpu.x"
