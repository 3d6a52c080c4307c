"""Sweep of the goal-adjacent margin clamp on the PyTorch port's Monte-Carlo
fleet (the port's counterpart of scripts/diag_goalclamp.py, which imports
JAX and stays).

The clamp removes the goal-standoff timeouts but lets plans pass closer to
spheres that block the goal. This sweeps (clamp, floor) over the bench
fleet (scripts/diag_timeouts_torch.py's :func:`build_fleet`: the same
fleet, worlds, wind and noise for every row) and prints the success, crash
and timeout shares and the crash share among episodes whose goal lies
within the safety margin of a true sphere's surface. As in the JAX script,
the fleet's seed is 0 and the method ``auto``: on a card each replan flies
through kernel B1 and its ticks through kernel B2. Each row carries its time: CUDA events on a card beside
the card's name and power limit as nvidia-smi gives them, the host clock on
the CPU.

    python scripts/diag_goalclamp_torch.py                  # the card, 2048 episodes
    python scripts/diag_goalclamp_torch.py --device cpu --episodes 16

Without a card it exits non-zero unless ``--device cpu`` is given. Imports
the port only.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from dart_planner_tpu_torch.common.device import card_label, to_host  # noqa: E402

from diag_convergence_torch import script_device  # noqa: E402
from diag_timeouts_torch import base_config, build_fleet, fly  # noqa: E402

# (goal_margin_clamp, goal_margin_floor) of each row
PAIRS = ((0.0, 0.1), (0.5, 0.1), (0.5, 0.3), (0.5, 0.45), (0.3, 0.3), (0.7, 0.3))


def goal_surface_distance(fleet) -> np.ndarray:
    """Per episode, the distance from the goal to the nearest live true
    sphere's surface (inf without one)."""
    g, to, tm = to_host(fleet.goals), to_host(fleet.true_obstacles), to_host(fleet.true_mask, bool)
    d = np.linalg.norm(g[:, None, :] - to[..., :3], axis=-1) - to[..., 3]
    return np.where(tm, d, np.inf).min(axis=1)


def row_configs(base=None) -> list:
    base = base or base_config()
    return [(clamp, floor, base._replace(mpc=base.mpc._replace(
        goal_margin_clamp=clamp, goal_margin_floor=floor))) for clamp, floor in PAIRS]


def rows(fleet, method: str = "auto", label: str = "") -> list:
    """Each (clamp, floor) row on ``fleet``, printed."""
    d_surf = goal_surface_distance(fleet)
    print(f"{'clamp':>6s} {'floor':>6s} {'success':>8s} {'crash':>7s} "
          f"{'timeout':>8s} {'crash@blocked':>13s} {'time':>12s}", flush=True)
    out = []
    for clamp, floor, cfg in row_configs():
        blocked = d_surf < cfg.mpc.safety_margin
        res, ms = fly(cfg, fleet, method)
        succ, crash = to_host(res.success, bool), to_host(res.crashed, bool)
        crash_blocked = float(crash[blocked].mean()) if blocked.any() else float("nan")
        r = {"clamp": clamp, "floor": floor, "success": float(succ.mean()),
             "crash": float(crash.mean()), "timeout": float(np.mean(~succ & ~crash)),
             "crash_blocked": crash_blocked, "blocked": int(blocked.sum()), "ms": ms}
        print(f"{clamp:6.2f} {floor:6.2f} {r['success']:8.4f} {r['crash']:7.4f} "
              f"{r['timeout']:8.4f} {crash_blocked:13.4f} {ms:9.3f} ms ({label})", flush=True)
        out.append(r)
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="the device to fly on (default cuda; cpu runs the plain path)")
    ap.add_argument("--episodes", type=int, default=2048)
    args = ap.parse_args(argv)
    device = script_device(ap, args.device)
    label = card_label(device)
    print(f"platform={device.type} ({label}) episodes={args.episodes}", flush=True)
    fleet = build_fleet(args.episodes, 0, device)
    return rows(fleet, "auto", label)


if __name__ == "__main__":
    main()
