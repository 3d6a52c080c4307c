"""The port's onboard autonomous controller with tiered failsafe
(``dart_planner_tpu_torch.apps.autonomous``), on the CPU.

The cases of tests/test_autonomous.py run against the port, and its
AUTONOMOUS replan is held against the JAX package's on the same state,
goal and obstacles at the controller's default planner
(``SE3MPCConfig(prediction_horizon=10, max_iterations=6)``):

- without obstacles (a convex problem, one Newton path): the planned
  positions within 1e-3 m and the command's thrust within 1e-3 N;
- with obstacles, where a solve may branch at line-search near-ties
  (ROADMAP C.7, C.9), the contract is the cost: each package's thrust
  plan, costed on the port's problem, within 1e-4 relative of the
  other's (these instances agree to 1e-7), and the plans' last knots
  within 1e-3 m.
"""

import numpy as np
import pytest
import torch

from dart_planner_tpu.apps import autonomous as J_auto
from dart_planner_tpu.common.types import DroneState as JDroneState
from dart_planner_tpu_torch.apps.autonomous import (
    OnboardAutonomousController,
    OperationalMode,
)
from dart_planner_tpu_torch.common.types import DroneState, Trajectory
from dart_planner_tpu_torch.planning import se3_mpc as T


def _ctl(**kw):
    return OnboardAutonomousController(device="cpu", **kw)


def _state(t=0.0, pos=(0, 0, 2.0)):
    return DroneState.create(timestamp=t, position=pos, device="cpu")


def _cloud_traj(n=10, dt=0.1, z=2.0):
    ts = np.arange(n) * dt
    pos = np.tile([0.0, 0.0, z], (n, 1)).astype(np.float32)
    return Trajectory(
        timestamps=torch.tensor(ts, dtype=torch.float32),
        positions=torch.tensor(pos),
        velocities=torch.zeros((n, 3)),
        accelerations=torch.zeros((n, 3)),
    )


# ---- tests/test_autonomous.py ----
def test_mode_selection_by_connection_quality():
    ctl = _ctl()
    traj = _cloud_traj()
    ctl.compute_control_command(_state(), traj, connection_quality=0.95)
    assert ctl.current_mode is OperationalMode.NOMINAL
    ctl.compute_control_command(_state(0.1), traj, connection_quality=0.5)
    assert ctl.current_mode is OperationalMode.DEGRADED
    ctl.compute_control_command(_state(0.2), None, connection_quality=0.9)
    assert ctl.current_mode is OperationalMode.DEGRADED
    ctl2 = _ctl()
    ctl2.compute_control_command(_state(), None, connection_quality=0.9)
    assert ctl2.current_mode is OperationalMode.AUTONOMOUS


def test_autonomous_mode_replans_locally():
    ctl = _ctl(replan_interval_s=0.0)
    ctl.set_goal((4.0, 0.0, 3.0))
    ctl.add_local_obstacle((2.0, 0.0, 2.5), 0.4)
    cmd = ctl.compute_control_command(_state(), None, connection_quality=0.0)
    assert ctl.current_mode is OperationalMode.AUTONOMOUS
    assert np.isfinite(float(cmd.thrust))
    st = ctl.get_system_status()
    assert st["planner_stats"]["total_plans"] == 1
    assert st["local_obstacles"] == 1


def test_autonomous_without_goal_hovers():
    ctl = _ctl()
    cmd = ctl.compute_control_command(_state(), None, connection_quality=0.0)
    assert float(cmd.thrust) == np.float32(1.0 * 9.81)  # fallback hover


def test_emergency_latches_and_descends():
    ctl = _ctl()
    ctl.trigger_emergency()
    cmd = ctl.compute_control_command(_state(), _cloud_traj(), connection_quality=1.0)
    assert ctl.current_mode is OperationalMode.EMERGENCY
    assert float(cmd.thrust) < 9.81
    assert ctl.get_system_status()["failsafe_activations"] == 1
    # the descent command is made on the controller's device, as JAX's value
    jcmd = J_auto.OnboardAutonomousController()._emergency_descent(None)
    assert cmd.thrust.device == cmd.torque.device == ctl.device
    assert float(cmd.thrust) == float(jcmd.thrust)
    assert cmd.thrust.dtype == torch.float32 and cmd.torque.shape == (3,)


def test_performance_stats_accumulate():
    ctl = _ctl()
    assert ctl.get_performance_stats() == {"status": "no_data"}
    for i in range(3):
        ctl.compute_control_command(_state(0.1 * i), _cloud_traj(), connection_quality=1.0)
    stats = ctl.get_performance_stats()
    assert stats["total_loops"] == 3
    assert stats["mean_loop_time_ms"] > 0


def test_repeated_plan_failures_latch_emergency():
    ctl = _ctl(replan_interval_s=0.0, max_plan_failures=3)
    ctl.set_goal((4.0, 0.0, 3.0))

    def boom(*a, **k):
        raise RuntimeError("solver down")

    ctl._planner.plan_trajectory = boom
    for i in range(3):
        ctl.compute_control_command(_state(0.1 * i), None, connection_quality=0.0)
    cmd = ctl.compute_control_command(_state(0.4), None, connection_quality=0.0)
    assert ctl.current_mode is OperationalMode.EMERGENCY
    assert float(cmd.thrust) < 9.81


# ---- the AUTONOMOUS replan against the JAX package ----
START = dict(timestamp=0.3, position=(0.2, -0.1, 2.0), velocity=(0.4, 0.1, -0.2))
GOAL = (4.0, 1.0, 3.0)


def _replan_both(obstacles):
    """One AUTONOMOUS tick of each package from the same state, goal and
    obstacles: (port controller, JAX controller, port cmd, JAX cmd)."""
    tc = _ctl(replan_interval_s=0.0)
    jc = J_auto.OnboardAutonomousController(replan_interval_s=0.0)
    for c in (tc, jc):
        c.set_goal(GOAL)
        for center, r in obstacles:
            c.add_local_obstacle(center, r)
    tcmd = tc.compute_control_command(DroneState.create(**START, device="cpu"), None, 0.0)
    jcmd = jc.compute_control_command(JDroneState.create(**START), None, 0.0)
    assert tc.current_mode is OperationalMode.AUTONOMOUS
    assert jc.current_mode.value == "autonomous"
    return tc, jc, tcmd, jcmd


def test_autonomous_replan_matches_jax_without_obstacles():
    tc, jc, tcmd, jcmd = _replan_both([])
    tp = tc._local_trajectory.positions.numpy()
    jp = np.asarray(jc._local_trajectory.positions, np.float32)
    assert tp.shape == jp.shape == (10, 3)
    np.testing.assert_allclose(tp, jp, atol=1e-3)
    np.testing.assert_allclose(float(tcmd.thrust), float(jcmd.thrust), atol=1e-3)
    np.testing.assert_allclose(tcmd.torque.numpy(), np.asarray(jcmd.torque), atol=1e-3)


@pytest.mark.parametrize("obstacles", [
    [((2.0, 0.5, 2.5), 0.6)],
    [((1.5, 0.0, 2.2), 0.5), ((3.0, 1.2, 2.8), 0.7)],
])
def test_autonomous_replan_with_obstacles_matches_jax_on_cost(obstacles):
    tc, jc, _, _ = _replan_both(obstacles)
    planner = tc._planner
    prob = planner._problem(DroneState.create(**START, device="cpu"))
    u_t = planner.last_solution
    u_j = torch.tensor(np.asarray(jc._planner.last_solution, np.float32))
    c_t = float(T._finalize(planner.config, prob, u_t).cost)
    c_j = float(T._finalize(planner.config, prob, u_j).cost)
    assert abs(c_t - c_j) <= 1e-4 * abs(c_j), (c_t, c_j)
    tp = tc._local_trajectory.positions.numpy()
    jp = np.asarray(jc._local_trajectory.positions, np.float32)
    np.testing.assert_allclose(tp[-1], jp[-1], atol=1e-3)
    assert np.isfinite(tp).all()
