"""The port's hardware mission stack (dart_planner_tpu_torch/hardware/:
``MissionRunner`` over ``SimulatedVehicleIO`` and over a transport-only
vehicle) on the CPU.

Held against the JAX package on the same inputs, where the runs do not
depend on the wall clock:

- the simulated vehicle's closed loop (smoother -> geometric controller ->
  rigid-body physics; the smoother in the JAX package's order of rate
  limits and smoothing, see control/smoother.py): a takeoff plan, then a planner-shaped plan spliced
  in mid-flight, 120 ticks of both packages' ``step()``; positions and
  velocities at atol 1e-4 m (m/s), the commanded thrust at atol 1e-3 N
  (float32 over 120 chained ticks; the largest differences seen are
  2.1e-7 m/s and 3.8e-6 N, the positions equal);
- the runner's own control tick for a vehicle without ``step`` (the
  MAVLink shape): smoother, geometric controller, body-rate command and
  the mixer's saturation count, tick by tick at fixed times; body rates at
  atol 1e-4 rad/s, normalized thrust at atol 1e-5.

Then the mission behaviours of tests/test_hardware_mission.py on the port:
the simulated mission to completion, the unconnected refusal, the altitude
failsafe, the saturation watchdog, ``stop_mission``, and a mission flown
over a transport-only stub vehicle. These run the scheduler on the wall
clock, so the completing missions keep the JAX tests' one retry. Their
planner is ``SE3MPCConfig(max_iterations=4, gn_warmup_iterations=2,
tail_iterations=0)``: about 21 ms a plan on a CPU against about 130 ms at
the default config, which at 10 Hz would starve the asyncio loop. The
MAVLink cases are in tests/test_torch_hardware_adapters.py.
"""

import asyncio
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dart_planner_tpu.common.types import DroneState as JDroneState
from dart_planner_tpu.common.types import Trajectory as JTrajectory
from dart_planner_tpu.hardware import mission as J_mission
from dart_planner_tpu.hardware.simulated_vehicle import SimulatedVehicleIO as JSim
from dart_planner_tpu_torch import DroneState, Trajectory, interop
from dart_planner_tpu_torch.control.smoother import update_trajectory
from dart_planner_tpu_torch.hardware import VehicleIO
from dart_planner_tpu_torch.hardware.mission import (
    MissionConfig,
    MissionRunner,
    start_mission,
)
from dart_planner_tpu_torch.hardware.simulated_vehicle import SimulatedVehicleIO
from dart_planner_tpu_torch.planning.se3_mpc import SE3MPCConfig, SE3MPCPlanner

SMALL = SE3MPCConfig(max_iterations=4, gn_warmup_iterations=2, tail_iterations=0)


def _planner():
    return SE3MPCPlanner(SMALL, device="cpu")


def _sim_vehicle(control_dt=0.01, z0=2.0):
    return SimulatedVehicleIO(
        {"initial_position": (0.0, 0.0, z0), "control_dt": control_dt}, device="cpu"
    )


def _fast_config(**kw):
    base = dict(
        control_frequency=100.0,
        planning_frequency=10.0,
        waypoint_tolerance=0.8,
        mission_timeout_s=240.0,
    )
    base.update(kw)
    return MissionConfig(**base)


def _plan_arrays(t0, p0, N=20):
    """A planner-shaped plan from ``p0``: accelerating along x, climbing."""
    ts = t0 + 0.1 * np.arange(N)
    tau = ts - t0
    acc = np.broadcast_to(np.float32([1.2, 0.3, 0.4]), (N, 3))
    vel = tau[:, None] * acc
    pos = np.asarray(p0) + 0.5 * tau[:, None] ** 2 * acc
    return tuple(np.array(x, np.float32) for x in (ts, pos, vel, acc))


# ------------------------------------------------------- parity with JAX


def test_simulated_vehicle_ticks_match_jax():
    async def arm(v):
        await v.connect()
        await v.arm()
        await v.takeoff(3.0)

    cfg = {"initial_position": (0.5, -0.5, 1.0), "control_dt": 0.0025}
    jv, tv = JSim(dict(cfg)), SimulatedVehicleIO(dict(cfg), device="cpu")
    # the JAX package's order of rate limits and smoothing (see
    # control/smoother.py), so both vehicles fly the same
    tv.smoother_config = interop.smoother_config_from_jax_fields(jv.smoother_config)
    asyncio.run(arm(jv))
    asyncio.run(arm(tv))
    for k in range(120):
        if k == 60:  # a replan splices in mid-flight (a min-jerk transition)
            p = np.asarray(jv.get_state().position)
            arrs = _plan_arrays(jv.sim_time, p + np.float32([0.8, 0.0, 0.2]))
            asyncio.run(jv.send_trajectory(JTrajectory(*[jnp.asarray(x) for x in arrs])))
            asyncio.run(tv.send_trajectory(Trajectory(*[torch.tensor(x) for x in arrs])))
            assert bool(tv.smoother_state.in_transition)
        js, ts = jv.step(), tv.step()
        if k % 20 == 19:
            np.testing.assert_allclose(ts.position.numpy(), np.asarray(js.position),
                                       atol=1e-4, err_msg=f"position, tick {k}")
            np.testing.assert_allclose(ts.velocity.numpy(), np.asarray(js.velocity),
                                       atol=1e-4, err_msg=f"velocity, tick {k}")
            np.testing.assert_allclose(tv.last_command.thrust.item(),
                                       float(np.asarray(jv.last_command.thrust)),
                                       atol=1e-3, err_msg=f"thrust, tick {k}")
    assert tv.sim_time == pytest.approx(jv.sim_time)
    assert ts.velocity[2].item() > 0.0  # climbing toward the takeoff altitude


class _Transport(VehicleIO):
    """A transport-only vehicle (no ``step``): its state walks from
    ``start`` toward ``goal`` over ``travel_s`` seconds of its clock, and
    it counts the body-rate targets the runner sends (the MAVLink
    adapter's shape)."""

    def __init__(self, goal, start=(0.0, 0.0, 2.0), travel_s=3.0, clock=time.time,
                 make_state=None):
        super().__init__({})
        self.goal = np.asarray(goal, np.float32)
        self.start = np.asarray(start, np.float32)
        self.travel_s = travel_s
        self.clock = clock
        self.t0 = None
        self.make_state = make_state or (lambda **kw: DroneState.create(device="cpu", **kw))
        self.body_rate_targets = []
        self.trajectories = 0

    def state_at(self, t):
        u = min((t - self.t0) / self.travel_s, 1.0)
        v = (self.goal - self.start) / self.travel_s * (u < 1.0)
        return self.make_state(timestamp=t, position=self.start + u * (self.goal - self.start),
                               velocity=v, attitude=(0.02, -0.01, 0.0))

    async def connect(self):
        self.connected = True
        self.t0 = self.clock()
        return True

    async def disconnect(self):
        self.connected = False

    def get_state(self):
        return self.state_at(self.clock())

    async def send_trajectory(self, trajectory):
        self.trajectories += 1
        return True

    def send_body_rate_target(self, brc):
        self.body_rate_targets.append(brc)

    async def arm(self):
        self.armed = True
        return True

    async def disarm(self):
        self.armed = False
        return True

    async def takeoff(self, altitude):
        return True

    async def land(self):
        return True

    async def emergency_stop(self):
        self.armed = False


def test_transport_control_tick_matches_jax():
    """The runner-owned stack for a vehicle without ``step``: a plan sent
    through the planning path's smoother update, then 60 control ticks at
    fixed times, against the JAX runner on the same states."""
    clock = {"t": 0.0}
    goal = (3.0, 1.0, 3.0)

    def tick_clock():
        return clock["t"]

    jveh = _Transport(goal, clock=tick_clock,
                      make_state=lambda **kw: JDroneState.create(**kw))
    tveh = _Transport(goal, clock=tick_clock)
    for v in (jveh, tveh):
        asyncio.run(v.connect())
        asyncio.run(v.arm())
    jr = J_mission.MissionRunner(jveh, J_mission.MissionConfig(control_frequency=100.0))
    tr = MissionRunner(tveh, MissionConfig(control_frequency=100.0), planner=_planner(),
                       device="cpu")
    tr._smoother_config = interop.smoother_config_from_jax_fields(jr._smoother_config)
    for r, w in ((jr, [np.asarray(goal, float)]), (tr, [np.asarray(goal, float)])):
        r._waypoints = w
        r.state.active = True
        r._sim_now = tick_clock
    arrs = _plan_arrays(0.0, (0.0, 0.0, 2.0))
    jr._smoother_state = J_mission.update_trajectory(
        jr._smoother_config, jr._smoother_state,
        JTrajectory(*[jnp.asarray(x) for x in arrs]), jnp.float32(0.0))
    tr._smoother_state = update_trajectory(
        tr._smoother_config, tr._smoother_state,
        Trajectory(*[torch.tensor(x) for x in arrs]), 0.0)
    for k in range(60):
        clock["t"] = 0.01 * (k + 1)
        jr._control_tick()
        tr._control_tick()
        jb, tb = jveh.body_rate_targets[-1], tveh.body_rate_targets[-1]
        np.testing.assert_allclose(tb.body_rates.numpy(), np.asarray(jb.body_rates),
                                   atol=1e-4, err_msg=f"body rates, tick {k}")
        np.testing.assert_allclose(tb.thrust.item(), float(np.asarray(jb.thrust)),
                                   atol=1e-5, err_msg=f"thrust, tick {k}")
    assert tr.state.commands_sent == jr.state.commands_sent == 60
    assert tr.mixer.saturation_events == jr.mixer.saturation_events
    assert tr.mixer.idle_faults == jr.mixer.idle_faults


# ------------------------------------------------------- mission behaviour


def _retry_once(run):
    """Wall-clock coupled: retried once, as the JAX package's tests are."""
    last = None
    for _ in range(2):
        try:
            return run()
        except AssertionError as e:
            last = e
    raise last


def test_simulated_mission_to_completion():
    """Full mission: connect -> arm -> 2 waypoints -> complete, through the
    4-loop orchestrator on the in-process vehicle."""
    _retry_once(_run_sim_mission)


def _run_sim_mission():
    async def main():
        vehicle = _sim_vehicle()
        await vehicle.connect()
        await vehicle.arm()
        vehicle.step()
        runner = MissionRunner(vehicle, _fast_config(), planner=_planner())
        assert runner.device == torch.device("cpu")  # the vehicle's device
        report = await runner.start_mission([(3.0, 0.0, 3.0), (3.0, 3.0, 3.0)])
        return runner, report

    runner, report = asyncio.run(main())
    assert report["mission_complete"], report
    assert report["waypoints_reached"] == 2
    assert report["failsafe_reason"] is None
    assert report["planning_failures"] == 0
    assert runner.planner.emergency_plans == 0
    assert report["commands_sent"] > 50
    assert report["telemetry_rows"] > 3
    assert report["scheduler"]["tasks"]["control"]["execution_count"] > 50


def test_final_waypoint_counts_once_unlike_jax():
    """A second arrival check after the final waypoint (the planning tick's,
    after the control tick's, before the loops stop) counts nothing in the
    port; the JAX package counts it again and then reports the mission
    incomplete (ROADMAP C, reference fault 17)."""
    goal = (1.0, 0.0, 2.0)
    port = MissionRunner(_sim_vehicle(), _fast_config(), planner=_planner())
    jax_runner = J_mission.MissionRunner(JSim({"initial_position": (0.0, 0.0, 2.0)}),
                                         J_mission.MissionConfig())
    at_goal = DroneState.create(position=goal, device="cpu")
    j_at_goal = JDroneState.create(position=goal)
    for runner, state in ((port, at_goal), (jax_runner, j_at_goal)):
        runner._waypoints = [np.asarray(goal)]
        runner._check_arrival(state)
        runner._check_arrival(state)
    assert port.state.waypoints_reached == 1
    assert port.get_performance_report()["mission_complete"]
    assert jax_runner.state.waypoints_reached == 2
    assert not jax_runner.get_performance_report()["mission_complete"]


def test_mission_requires_connection():
    async def main():
        vehicle = _sim_vehicle()
        runner = MissionRunner(vehicle, _fast_config(), planner=_planner())
        with pytest.raises(RuntimeError, match="not connected"):
            await runner.start_mission([(1.0, 0.0, 2.0)])

    asyncio.run(main())


def test_runner_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        SimulatedVehicleIO({"initial_position": (0.0, 0.0, 2.0)})
    with pytest.raises(RuntimeError, match='device="cpu"'):
        MissionRunner(_Transport((1.0, 0.0, 2.0)))


def test_failsafe_on_altitude_violation():
    """A waypoint above the ceiling drives the vehicle through it ->
    failsafe + landed."""

    async def main():
        vehicle = _sim_vehicle()
        await vehicle.connect()
        await vehicle.arm()
        vehicle.step()
        runner = MissionRunner(
            vehicle, _fast_config(max_altitude=2.5, mission_timeout_s=120.0),
            planner=_planner(),
        )
        return await runner.start_mission([(0.0, 0.0, 6.0)])

    report = asyncio.run(main())
    assert not report["mission_complete"]
    assert "altitude" in (report["failsafe_reason"] or ""), report


def test_saturation_watchdog_catches_unstable_control():
    """At control_dt=0.02 the attitude loop (gains tuned for 400 Hz)
    chatters at the torque limit; the mixer counts the saturated
    allocations and the watchdog grounds the mission."""

    async def main():
        vehicle = _sim_vehicle(control_dt=0.02)
        await vehicle.connect()
        await vehicle.arm()
        vehicle.step()
        runner = MissionRunner(
            vehicle,
            _fast_config(saturation_watchdog_threshold=25, mission_timeout_s=120.0),
            planner=_planner(),
        )
        return await runner.start_mission([(3.0, 0.0, 3.0)])

    report = asyncio.run(main())
    assert not report["mission_complete"]
    assert "saturation" in (report["failsafe_reason"] or ""), report
    assert report["saturation_events"] > 25


def test_stop_mission_lands():
    async def main():
        vehicle = _sim_vehicle()
        await vehicle.connect()
        await vehicle.arm()
        runner = MissionRunner(vehicle, _fast_config(), planner=_planner())
        task = asyncio.create_task(runner.start_mission([(50.0, 0.0, 3.0)]))
        await asyncio.sleep(1.0)
        await runner.stop_mission()
        return vehicle, await asyncio.wait_for(task, timeout=30.0)

    vehicle, report = asyncio.run(main())
    assert not report["mission_complete"]
    # land() sent a descent plan to the smoother: its last knot is on the ground
    assert vehicle.smoother_state.positions[-1, 2].item() == 0.0


def test_transport_only_mission_to_completion():
    """A vehicle without ``step``: the runner's own smoother and geometric
    controller send body-rate targets at the control rate, and replans go
    out over the transport."""

    def run():
        goal = (2.0, 0.0, 3.0)
        vehicle = _Transport(goal, travel_s=2.0)

        async def main():
            await vehicle.connect()
            return await start_mission(
                vehicle, [goal], config=_fast_config(planning_frequency=5.0,
                                                     mission_timeout_s=60.0),
                planner=_planner(), device="cpu",
            )

        report = asyncio.run(main())
        assert report["mission_complete"], report
        assert report["waypoints_reached"] == 1
        assert len(vehicle.body_rate_targets) > 10  # the control loop ran
        assert report["commands_sent"] == len(vehicle.body_rate_targets)
        assert vehicle.trajectories >= 1 and report["avg_planning_time_ms"] > 0.0
        assert vehicle.armed  # the runner armed the vehicle itself
        rates = torch.stack([b.body_rates for b in vehicle.body_rate_targets])
        assert torch.isfinite(rates).all()

    _retry_once(run)
