"""Beginner: arm -> takeoff -> hover -> land on the simulated vehicle.

PyTorch counterpart of examples/beginner/minimal_takeoff.py; the flight
logic lives in :mod:`dart_planner_tpu_torch.apps.minimal_takeoff`. The
vehicle (smoother -> geometric controller -> rigid-body physics, one eager
tick at a time) runs on the card by default, or with ``--device cpu`` on
the CPU.

    PYTHONPATH=. python examples_torch/beginner/minimal_takeoff.py [--device cpu]
"""

import argparse
import asyncio

from dart_planner_tpu_torch.apps.minimal_takeoff import minimal_takeoff
from dart_planner_tpu_torch.common.device import resolve_device


def main(altitude: float = 3.0, hover_s: float = 2.0, device=None) -> dict:
    """Fly the takeoff; returns its altitudes (m)."""
    out = asyncio.run(minimal_takeoff(altitude=altitude, hover_s=hover_s,
                                      device=resolve_device(device)))
    print(
        f"peak {out['peak_altitude']:.2f} m | "
        f"hover {out['hover_altitude']:.2f} m | "
        f"landed {out['final_altitude']:.2f} m "
        f"(target {out['target_altitude']:.1f} m)"
    )
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="torch device (default: the card)")
    main(device=parser.parse_args().device)
