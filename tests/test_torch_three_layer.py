"""The port's three-layer hierarchy on the CPU: L1 ``GlobalMissionPlanner``
goals -> L2 SE(3) MPC plans -> the trajectory smoother -> the real-time
control-loop executor (the C++ ``native/rt_executor.cpp`` when it builds,
the Python loop otherwise) -> a rigid plant flown on the loop's thrust and
body-rate commands, as tests/test_three_layer_rt.py flies the JAX package;
and the planner-controller contract of
tests/test_planner_controller_contract.py:94 (the smoother accepts the
planner's output).

Held against the JAX package on the same inputs:

- one pass through the layers from the same states: L1's goals exactly
  (float32 numpy), and the smoother's setpoints from the same plan at
  atol 1e-5 (float32 in the same order; the port's smoother in the JAX
  package's order of rate limits and smoothing, see control/smoother.py);
- the contract: one plan of the JAX planner fed to both smoothers at seven
  times across its span (atol 1e-5), and the port's own plan at the
  default config within the contract's 0.5 m of its last knot.

The closed mission runs the RT loop as a real thread on the wall clock,
so it keeps the JAX test's one retry, and its planner is
``SE3MPCConfig(max_iterations=4, gn_warmup_iterations=2,
tail_iterations=0)``: about 21 ms a plan on a CPU against about 130 ms at
the default config.
"""

import time

import numpy as np
import pytest
import torch

from dart_planner_tpu.common.types import DroneState as JDroneState
from dart_planner_tpu.control.smoother import TrajectorySmoother as JSmoother
from dart_planner_tpu.planning import global_mission as J_gmp
from dart_planner_tpu.planning.se3_mpc import SE3MPCConfig as JConfig
from dart_planner_tpu.planning.se3_mpc import SE3MPCPlanner as JPlanner
from dart_planner_tpu_torch import DroneState, Trajectory, interop
from dart_planner_tpu_torch.control.smoother import TrajectorySmoother
from dart_planner_tpu_torch.ops import so3
from dart_planner_tpu_torch.planning.global_mission import (
    GlobalMissionPlanner,
    MissionPhase,
    SemanticWaypoint,
)
from dart_planner_tpu_torch.planning.se3_mpc import SE3MPCConfig, SE3MPCPlanner
from dart_planner_tpu_torch.runtime.rt_executor import create_control_loop

GRAVITY = np.array([0.0, 0.0, -9.81])
MASS = 1.5
SMALL = SE3MPCConfig(max_iterations=4, gn_warmup_iterations=2, tail_iterations=0)
WAYPOINTS = [((3.0, 0.0, 3.0), "survey_corner"), ((3.0, 3.0, 3.0), "goal_pad")]
FIELDS = ("timestamps", "positions", "velocities", "accelerations")


class _Plant:
    """Minimal rigid plant flown on thrust + body-rate commands."""

    def __init__(self, position):
        self.pos = np.asarray(position, float)
        self.vel = np.zeros(3)
        self.att = np.zeros(3)  # roll, pitch, yaw

    def step(self, thrust, rates, dt):
        self.att = self.att + np.asarray(rates) * dt
        self.att[:2] = np.clip(self.att[:2], -0.6, 0.6)
        R = so3.euler_to_rotmat(torch.tensor(self.att, dtype=torch.float32)).numpy()
        acc = R @ np.array([0.0, 0.0, float(thrust)]) / MASS + GRAVITY
        self.vel = self.vel + acc * dt
        self.pos = self.pos + self.vel * dt

    def drone_state(self, t):
        return DroneState.create(timestamp=t, position=self.pos, velocity=self.vel,
                                 attitude=self.att, device="cpu")


def _attitude_setpoint(acc_des):
    """Desired attitude + thrust from the smoothed acceleration setpoint:
    differential-flatness formulas at yaw 0."""
    u = MASS * (np.asarray(acc_des, float) - GRAVITY)
    pitch = np.arctan2(u[0], max(u[2], 1e-6))
    roll = np.arctan2(-u[1], float(np.hypot(u[0], u[2])))
    return np.array([roll, pitch, 0.0]), float(np.linalg.norm(u))


def _missions():
    j = J_gmp.GlobalMissionPlanner()
    j.set_mission_waypoints([J_gmp.SemanticWaypoint(p, lab) for p, lab in WAYPOINTS])
    t = GlobalMissionPlanner()
    t.set_mission_waypoints([SemanticWaypoint(p, lab) for p, lab in WAYPOINTS])
    return j, t


def _as_port(traj):
    """A JAX plan's fields as CPU tensors."""
    return Trajectory(*[torch.tensor(np.asarray(getattr(traj, k), np.float32))
                        for k in FIELDS])


def test_layers_match_jax_on_the_same_states():
    """L1 goals and L3 setpoints of both packages from the same states; the
    L2 plan is the JAX planner's, handed to both smoothers."""
    jm, tm = _missions()
    jplanner = JPlanner(JConfig(max_iterations=4, gn_warmup_iterations=2,
                                tail_iterations=0))
    jsm = JSmoother()
    tsm = TrajectorySmoother(config=interop.smoother_config_from_jax_fields(jsm.config),
                             device="cpu")
    states = [((0.0, 0.0, 0.5), (0.0, 0.0, 0.0)), ((0.1, 0.0, 4.7), (0.2, 0.0, 0.3)),
              ((2.8, 0.1, 3.0), (0.5, 0.1, 0.0)), ((3.0, 2.2, 3.0), (0.0, 0.6, 0.0))]
    for i, (pos, vel) in enumerate(states):
        now = 0.1 * i
        js = JDroneState.create(timestamp=now, position=pos, velocity=vel)
        ts = DroneState.create(timestamp=now, position=pos, velocity=vel, device="cpu")
        jg, tg = jm.get_current_goal(js), tm.get_current_goal(ts)
        np.testing.assert_array_equal(tg, jg)
        assert tm.current_phase.value == jm.current_phase.value
        traj = jplanner.plan_trajectory(js, jg)
        traj = traj.replace(timestamps=traj.timestamps - traj.timestamps[..., 0] + now)
        jsm.update_trajectory(traj, now)
        tsm.update_trajectory(_as_port(traj), now)
        for dt in (0.0, 0.005, 0.05):
            jout = jsm.get_desired_state(now + dt, js)
            tout = tsm.get_desired_state(now + dt, ts)
            for name, a, b in zip(("pos", "vel", "acc"), jout, tout):
                np.testing.assert_allclose(b.numpy(), np.asarray(a, np.float32), atol=1e-5,
                                           rtol=0, err_msg=f"{name}, state {i}, +{dt}")
    assert tm.current_phase is MissionPhase.LANDING  # past both waypoints


@pytest.fixture(scope="module")
def contract_plans():
    """One plan of each package from the contract's state, at the default
    config (one-shot: the ~130 ms a CPU plan costs does not matter here)."""
    jplanner = JPlanner(JConfig())
    jplanner.add_obstacle(center=(2.5, 0.5, 2.5), radius=0.5)
    js = JDroneState.create(timestamp=1.5, position=(0.0, 0.0, 2.0),
                            velocity=(0.5, 0.0, 0.0))
    tplanner = SE3MPCPlanner(SE3MPCConfig(), device="cpu")
    tplanner.add_obstacle(center=(2.5, 0.5, 2.5), radius=0.5)
    ts = DroneState.create(timestamp=1.5, position=(0.0, 0.0, 2.0),
                           velocity=(0.5, 0.0, 0.0), device="cpu")
    ttraj = tplanner.plan_trajectory(ts, (5.0, 1.0, 3.0))
    assert tplanner.get_planning_stats()["success_rate"] > 0.9  # converged
    assert tplanner.emergency_plans == 0
    return js, jplanner.plan_trajectory(js, (5.0, 1.0, 3.0)), ts, ttraj


def test_smoother_accepts_planner_output(contract_plans):
    """The C2 smoother splices the planner's trajectory and serves
    interpolated setpoints inside the plan's time span."""
    js, jtraj, ts, ttraj = contract_plans
    # both smoothers on the JAX plan (the port's in the JAX package's order
    # of rate limits and smoothing): the same setpoints
    jsm = JSmoother()
    tsm = TrajectorySmoother(config=interop.smoother_config_from_jax_fields(jsm.config),
                             device="cpu")
    knots = np.asarray(jtraj.timestamps)
    jsm.update_trajectory(jtraj, float(knots[0]))
    tsm.update_trajectory(_as_port(jtraj), float(knots[0]))
    for t in np.linspace(float(knots[0]), float(knots[-1]), 7):
        jout = jsm.get_desired_state(float(t), js)
        tout = tsm.get_desired_state(float(t), ts)
        for a, b in zip(jout, tout):
            assert torch.isfinite(b).all()
            np.testing.assert_allclose(b.numpy(), np.asarray(a, np.float32), atol=1e-5,
                                       rtol=0)
    # the port's own plan, as the contract asks of the JAX one
    sm = TrajectorySmoother(device="cpu")
    knots = ttraj.timestamps.numpy()
    sm.update_trajectory(ttraj, float(knots[0]))
    for t in np.linspace(float(knots[0]), float(knots[-1]), 7):
        for v in sm.get_desired_state(float(t), ts):
            assert torch.isfinite(v).all()
    p_end, _, _ = sm.get_desired_state(float(knots[-1]), ts)
    np.testing.assert_allclose(p_end.numpy(), ttraj.positions[-1].numpy(), atol=0.5)


def test_three_layer_mission_through_rt_executor():
    last = None
    for _ in range(2):
        try:
            _run()
            return
        except AssertionError as e:
            last = e
    raise last


def _run():
    mission = GlobalMissionPlanner()
    mission.set_mission_waypoints([SemanticWaypoint(p, lab) for p, lab in WAYPOINTS])
    planner = SE3MPCPlanner(SMALL, device="cpu")
    smoother = TrajectorySmoother(device="cpu")
    loop = create_control_loop(frequency_hz=200.0, prefer_native=True)
    loop.set_gains(
        [1.5, 1.5, 4.0], [0.0, 0.0, 0.2], [1.0, 1.0, 2.5],
        [6.0, 6.0, 3.0], [0.0, 0.0, 0.0], [0.5, 0.5, 0.3],
    )

    plant = _Plant([0.0, 0.0, 0.5])
    phases_seen = set()
    waypoints_hit = 0

    st = plant.drone_state(0.0)
    traj = planner.plan_trajectory(st, mission.get_current_goal(st))
    smoother.update_trajectory(traj, 0.0)
    smoother.get_desired_state(0.0, st)

    loop.start()
    try:
        t0 = time.perf_counter()
        last_plan = -1.0
        last_tick = t0
        deadline = t0 + 45.0
        goal = None
        while time.perf_counter() < deadline:
            now = time.perf_counter() - t0
            st = plant.drone_state(now)
            phases_seen.add(mission.current_phase)
            if now - last_plan >= 0.1:  # 10 Hz replans (L1 + L2)
                goal = mission.get_current_goal(st)
                traj = planner.plan_trajectory(st, goal)
                traj = traj.replace(
                    timestamps=traj.timestamps - traj.timestamps[..., :1] + now
                )
                smoother.update_trajectory(traj, now)
                last_plan = now
            # smoothed setpoint -> RT loop -> plant; the attitude setpoint
            # carries the lateral position feedback (the C++ loop's PID
            # corrects thrust/z only)
            pos_d, vel_d, acc_d = (x.numpy().astype(float)
                                   for x in smoother.get_desired_state(now, st))
            acc_cmd = acc_d + 2.5 * (pos_d - plant.pos) + 3.0 * (vel_d - plant.vel)
            att_d, thrust_ff = _attitude_setpoint(acc_cmd)
            loop.set_state(plant.pos, plant.vel, plant.att, np.zeros(3))
            loop.set_setpoint(pos_d, vel_d, att_d, np.zeros(3), thrust_ff=thrust_ff)
            cmd = loop.get_command()
            t_now = time.perf_counter()
            dt = min(t_now - last_tick, 0.05)
            last_tick = t_now
            if cmd is not None:
                plant.step(cmd["thrust"],
                           [cmd["roll_rate"], cmd["pitch_rate"], cmd["yaw_rate"]], dt)
            if goal is not None and np.linalg.norm(plant.pos - np.asarray(goal)) < 0.6:
                waypoints_hit += 1
            if mission.current_phase in (MissionPhase.LANDING, MissionPhase.EMERGENCY):
                break
            time.sleep(0.004)
    finally:
        loop.stop()

    stats = loop.get_stats()
    assert MissionPhase.TAKEOFF in phases_seen
    assert MissionPhase.NAVIGATION in phases_seen, phases_seen
    assert waypoints_hit > 0, f"plant never reached a goal; pos={plant.pos}"
    assert mission.current_phase is MissionPhase.LANDING, (mission.current_phase, plant.pos)
    assert stats["iteration_count"] > 500, stats
    assert stats["missed_deadlines"] <= 0.5 * stats["iteration_count"], stats
    # planner health through the whole mission: every plan valid (no hover
    # fallback). The converged share is a property of the 4-round budget
    # (0.03 for the port and 0.07 for JAX on the same 30 random states at
    # this config), so the JAX test's 0.9 bar is held at the default config
    # in test_smoother_accepts_planner_output instead
    pstats = planner.get_planning_stats()
    assert pstats["emergency_plans"] == 0, pstats
    assert pstats["total_plans"] > 20, pstats
