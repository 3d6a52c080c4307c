"""Advanced: the full three-layer stack in one closed loop.

PyTorch counterpart of examples/advanced/three_layer_mission.py: the L1
mission planner feeds semantic waypoints, L2 SE(3) MPC plans around
mapper-sourced obstacles, and a perfect-tracking plant integrates each
plan's first acceleration. On the card (the default) each of the 40
replans (B=1, two-phase) launches kernel B1 twice; with ``--device cpu``
the planner runs the plain PyTorch loop.

    PYTHONPATH=. python examples_torch/advanced/three_layer_mission.py [--device cpu]
"""

import argparse

import numpy as np

from dart_planner_tpu_torch.common.device import resolve_device, to_host
from dart_planner_tpu_torch.common.types import DroneState
from dart_planner_tpu_torch.perception import GeometricMapper
from dart_planner_tpu_torch.planning.global_mission import GlobalMissionPlanner, SemanticWaypoint
from dart_planner_tpu_torch.planning.se3_mpc import SE3MPCConfig, SE3MPCPlanner


def main(replans: int = 40, horizon: int = 12, device=None) -> dict:
    """Fly ``replans`` 10 Hz replans at ``SE3MPCConfig(prediction_horizon=
    horizon)``. Returns the position after each replan, the phases printed,
    and the planner's stats."""
    dev = resolve_device(device)
    mission = GlobalMissionPlanner()
    mission.set_mission_waypoints(
        [
            SemanticWaypoint((0.0, 0.0, 3.0), "takeoff_point"),
            SemanticWaypoint((6.0, 2.0, 3.0), "survey_corner"),
            SemanticWaypoint((10.0, -2.0, 4.0), "goal_pad"),
        ]
    )

    mapper = GeometricMapper(resolution=0.5, device=dev)
    mapper.add_obstacle((5.0, 0.0, 3.0), 0.8)

    planner = SE3MPCPlanner(SE3MPCConfig(prediction_horizon=horizon), device=dev)
    # L2 obstacle source: spheres extracted from the occupancy map
    obstacles, mask = mapper.extract_obstacles(center=(5.0, 0.0, 3.0))
    for row, ok in zip(obstacles, mask):
        if ok:
            planner.add_obstacle(row[:3], float(row[3]))

    pos = np.float32([0.0, 0.0, 0.5])  # on a raised pad (plans below
    vel = np.zeros(3, np.float32)      # 0.1 m altitude are rejected)
    t = 0.0
    positions, phases = [], []
    for step in range(replans):  # 10 Hz replan
        state = DroneState.create(timestamp=t, position=pos, velocity=vel, device=dev)
        goal = mission.get_current_goal(state)
        traj = planner.plan_trajectory(state, goal)
        # perfect-tracking plant: integrate the plan's first acceleration
        acc = to_host(traj.accelerations[1], np.float32)
        vel = vel + acc * 0.1
        pos = pos + vel * 0.1
        t += 0.1
        positions.append(pos)
        if step % 10 == 0:
            phases.append(mission.current_phase.value)
            print(
                f"t={t:4.1f}s phase={mission.current_phase.value:<12} "
                f"pos=({pos[0]:5.2f},{pos[1]:5.2f},{pos[2]:4.2f}) "
                f"goal=({goal[0]:.1f},{goal[1]:.1f},{goal[2]:.1f})"
            )
    stats = planner.get_planning_stats()
    print("mission stats:", stats)
    return {"positions": np.stack(positions), "phases": phases, "stats": stats}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; cpu runs the plain loop)")
    main(device=parser.parse_args().device)
