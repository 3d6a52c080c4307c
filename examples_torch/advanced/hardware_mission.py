"""Advanced: the hardware mission orchestrator over a VehicleIO.

PyTorch counterpart of examples/advanced/hardware_mission.py, after the
reference's ``PixhawkInterface.start_mission`` call stack: one call gathers
the control loop, the SE(3) MPC planning loop, telemetry, and the safety
monitor (velocity/altitude envelope, heartbeat, motor-saturation watchdog)
against any vehicle. Here the vehicle is the pure-software
``SimulatedVehicleIO`` on the card (the default; ``--device cpu`` for the
CPU), flown at 100 Hz control and 10 Hz planning (400 and 50 on flight
hardware); every plan launches kernel B1 twice on the card. An eager
vehicle tick on the card takes longer than the 10 ms control period, so
the control task may run below 100 Hz; the example prints the rate it
reached.

The port counts the final waypoint once: where the JAX example may count
it a second time (when the control tick and the planning tick both see
the vehicle inside the radius, e.g. 4 of 3 waypoints) and then report the
mission incomplete, the port reports it complete.

    PYTHONPATH=. python examples_torch/advanced/hardware_mission.py [--device cpu]
"""

import argparse
import asyncio
import time

import numpy as np

from dart_planner_tpu_torch.common.device import card_label, to_host
from dart_planner_tpu_torch.hardware import MissionConfig, MissionRunner, SimulatedVehicleIO
from dart_planner_tpu_torch.planning.se3_mpc import SE3MPCConfig, SE3MPCPlanner

WAYPOINTS = [(3.0, 0.0, 3.0), (3.0, 3.0, 3.5), (0.0, 0.0, 2.5)]
CONTROL_HZ = 100.0  # 400 on flight hardware
PLANNING_HZ = 10.0  # 50 on flight hardware


async def fly(planner_config=None, device=None) -> dict:
    """Connect, arm and fly WAYPOINTS; returns the runner's report with the
    final position, the plans made, the mission's wall seconds and the
    vehicle's device."""
    vehicle = SimulatedVehicleIO(
        {"initial_position": (0.0, 0.0, 2.0), "control_dt": 0.01}, device=device
    )
    await vehicle.connect()
    await vehicle.arm()
    vehicle.step()  # the control path's first tick, before the clock starts

    planner = SE3MPCPlanner(planner_config or SE3MPCConfig(), device=vehicle.device)
    runner = MissionRunner(
        vehicle,
        MissionConfig(
            control_frequency=CONTROL_HZ,
            planning_frequency=PLANNING_HZ,
            waypoint_tolerance=0.8,
        ),
        planner=planner,
    )
    print(f"flying {len(WAYPOINTS)} waypoints ...")
    t0 = time.perf_counter()
    report = await runner.start_mission(WAYPOINTS)
    wall = time.perf_counter() - t0
    return {**report, "final_position": to_host(vehicle.get_state().position, np.float32),
            "plans": planner.planning_stats["total_plans"], "wall_s": wall,
            "device": vehicle.device}


def main(planner_config=None, device=None) -> dict:
    """Fly the mission with ``SE3MPCPlanner(planner_config)`` (default
    ``SE3MPCConfig()``). Returns the runner's report with the final
    position, the plans made, the mission's wall seconds and the control
    rate reached."""
    out = asyncio.run(fly(planner_config, device))
    out["control_hz"] = out["commands_sent"] / out["wall_s"]
    out["card"] = label = card_label(out["device"])
    print(f"mission complete: {out['mission_complete']}")
    print(f"waypoints reached: {out['waypoints_reached']}/{out['waypoints_total']}")
    print(f"avg planning time: {out.get('avg_planning_time_ms', 0):.1f} ms ({label})")
    print(f"commands sent: {out['commands_sent']}")
    print(f"control rate reached: {out['control_hz']:.1f} Hz of {CONTROL_HZ:g} over "
          f"{out['wall_s']:.1f} s ({label})")
    print(f"final position: {out['final_position']}")
    if out["failsafe_reason"]:
        print(f"failsafe: {out['failsafe_reason']}")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="torch device (default: the card)")
    main(device=parser.parse_args().device)
