"""Minimal takeoff demo (PyTorch counterpart of
:mod:`dart_planner_tpu.apps.minimal_takeoff`).

Port of the reference ``minimal_takeoff.py``: the smallest end-to-end
flight — create a vehicle, arm, take off, hover, land — exercising the
full smoother -> controller -> physics stack without any cloud. The
vehicle runs on ``device`` (default: the card).
"""

from __future__ import annotations

import asyncio
from typing import Dict

from dart_planner_tpu_torch.common.device import to_host
from dart_planner_tpu_torch.common.logging_config import get_logger
from dart_planner_tpu_torch.hardware import VehicleIOFactory

logger = get_logger("apps.minimal_takeoff")


async def minimal_takeoff(
    altitude: float = 3.0,
    hover_s: float = 2.0,
    vehicle_type: str = "simulated",
    device=None,
) -> Dict[str, float]:
    """arm -> takeoff -> hover -> land; returns flight summary."""
    vehicle = VehicleIOFactory.create(vehicle_type, {"device": device})
    await vehicle.connect()
    await vehicle.arm()
    logger.info("taking off to %.1f m", altitude)
    await vehicle.takeoff(altitude)
    vehicle.run_for(5.0)
    peak = float(to_host(vehicle.get_state().position)[2])
    vehicle.run_for(hover_s)
    hover_z = float(to_host(vehicle.get_state().position)[2])
    logger.info("landing")
    await vehicle.land()
    vehicle.run_for(6.0)
    final_z = float(to_host(vehicle.get_state().position)[2])
    await vehicle.disarm()
    return {
        "peak_altitude": peak,
        "hover_altitude": hover_z,
        "final_altitude": final_z,
        "target_altitude": altitude,
    }


def main(device=None) -> None:
    out = asyncio.run(minimal_takeoff(device=device))
    print(
        f"takeoff demo: peak {out['peak_altitude']:.2f} m, "
        f"hover {out['hover_altitude']:.2f} m, "
        f"landed at {out['final_altitude']:.2f} m"
    )


if __name__ == "__main__":
    main()
