"""The trajectory smoother's order of rate limits and smoothing
(dart_planner_tpu_torch/control/smoother.py, ROADMAP C reference fault 16)
at the deployment's cadence: the simulated vehicle at 400 Hz with a replan
every 8 ticks (50 Hz) toward the two waypoints of
tests/test_hardware_mission.py, on the CPU, with no wall clock.

With the port's default order (limits on the smoothed command) it reaches
both waypoints (at ~2.5 s of its clock). With the JAX package's order (the
port configured by ``interop``, which flies as the JAX package to the mm)
the lagging command carries it through the first waypoint at ~1.8 m/s and
it never settles on the second: at 3.2 s it is still ~3 m from it, and it
goes on to orbit it with a growing radius (6.4 m out after 40 s). The
planner is ``SE3MPCConfig(max_iterations=4, gn_warmup_iterations=2,
tail_iterations=0)`` (~21 ms a CPU plan; the default takes ~130 ms and
flies the same, within 1 mm at 2 s).
"""

import asyncio

import numpy as np
import pytest

from dart_planner_tpu_torch.control.smoother import SmootherConfig
from dart_planner_tpu_torch.hardware.simulated_vehicle import SimulatedVehicleIO
from dart_planner_tpu_torch.planning.se3_mpc import SE3MPCConfig, SE3MPCPlanner

WAYPOINTS = [np.float32([3.0, 0.0, 3.0]), np.float32([3.0, 3.0, 3.0])]


def _fly_at_deployment_cadence(cfg, seconds):
    """The sim times at which the vehicle came within 0.8 m of each
    waypoint, and where it was at the end."""
    v = SimulatedVehicleIO({"initial_position": (0.0, 0.0, 2.0)}, device="cpu")
    v.smoother_config = cfg._replace(failsafe_timeout=60.0)
    asyncio.run(v.connect())
    asyncio.run(v.arm())
    planner = SE3MPCPlanner(SE3MPCConfig(max_iterations=4, gn_warmup_iterations=2,
                                         tail_iterations=0), device="cpu")
    reached, k = [], 0
    while v.sim_time < seconds and len(reached) < 2:
        if k % 8 == 0:
            traj = planner.plan_trajectory(v.get_state(), WAYPOINTS[len(reached)])
            traj = traj.replace(timestamps=traj.timestamps - traj.timestamps[..., :1]
                                + v.sim_time)
            asyncio.run(v.send_trajectory(traj))
        pos = v.step().position.numpy()
        k += 1
        if np.linalg.norm(pos - WAYPOINTS[len(reached)]) < 0.8:
            reached.append(v.sim_time)
    return reached, pos


@pytest.mark.parametrize("order", ["after_smoothing", "before_smoothing"])
def test_vehicle_at_the_deployment_cadence(order):
    reached, pos = _fly_at_deployment_cadence(SmootherConfig(rate_limits=order), 3.2)
    if order == "after_smoothing":
        assert len(reached) == 2, reached
    else:
        assert len(reached) == 1, reached
        assert np.linalg.norm(pos - WAYPOINTS[1]) > 2.0, pos
