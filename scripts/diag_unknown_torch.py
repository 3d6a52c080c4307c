"""Calibration of the unknown-space speed cap on the PyTorch port's
Monte-Carlo fleet (the port's counterpart of scripts/diag_unknown.py, which
imports JAX and stays).

Flies the bench config-4 fleet (scripts/diag_timeouts_torch.py's
:func:`build_fleet`: randomized starts and goals, wind, sensor noise,
mapper-perceived sphere worlds, 3 m in-flight sensing; the same draws for
every row) at each ``--caps`` setting of ``unknown_speed_cap`` and prints
success, crash, tracking RMSE, clearance and the final distance's p95,
after the census of the corridor's coverage that the cap keys on; then
checks whether the uncapped crashes happen on episodes with unknown corridor
samples. The defaults are the shipped ``ClosedLoopConfig`` values (margin
1.5, ramp 3.0, coverage 0.6). On a card ``--method auto`` flies each replan
through kernel B1 and its ticks through kernel B2. Each row carries its
time: CUDA events on a card beside the card's name and power limit as
nvidia-smi gives them, the host clock on the CPU.

    python scripts/diag_unknown_torch.py                  # the card, 2048 episodes
    python scripts/diag_unknown_torch.py --device cpu --episodes 16 --caps 0,2

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
from dart_planner_tpu_torch.sim import closed_loop  # noqa: E402

from diag_convergence_torch import script_device  # noqa: E402
from diag_timeouts_torch import base_config as timeouts_base  # noqa: E402
from diag_timeouts_torch import build_fleet, fly  # noqa: E402

UNKNOWN_BELOW = 0.5  # a corridor sample observed less than this is unknown


def base_config(margin: float = 1.5, ramp: float = 3.0, coverage: float = 0.6):
    """The JAX script's base row: the timeout census's shipping row with
    the cap off and the margin, ramp and coverage as given."""
    return timeouts_base()._replace(unknown_speed_cap=0.0, unknown_margin=margin,
                                    unknown_ramp=ramp, unknown_coverage=coverage)


def corridor_census(fleet) -> dict:
    cov = to_host(fleet.corridor)
    unk = cov < UNKNOWN_BELOW
    out = {"mean": float(cov.mean()), "p10": float(np.percentile(cov, 10)),
           "samples_unknown": float(unk.mean()),
           "episodes_with_unknown": float(unk.any(axis=1).mean())}
    print(f"corridor coverage: mean={out['mean']:.3f} p10={out['p10']:.3f} "
          f"samples-unknown={out['samples_unknown']:.3f} "
          f"episodes-with-unknown={out['episodes_with_unknown']:.3f}", flush=True)
    return out


def row_configs(base, caps) -> list:
    """(cap, config, whether the row keys the cap on the corridor) of each
    cap row."""
    return [(cap, base._replace(unknown_speed_cap=cap), cap > 0) for cap in caps]


def rows(fleet, caps=(0.0, 5.0, 4.0, 3.0), method: str = "auto", base=None,
         label: str = "") -> dict:
    """The corridor census, each cap row and the uncapped crash check on
    ``fleet``, printed."""
    base = base or base_config()
    census = corridor_census(fleet)
    print(f"margin={base.unknown_margin} ramp={base.unknown_ramp} "
          f"coverage={base.unknown_coverage}")
    print(f"{'cap':>5s} {'success':>8s} {'crash':>7s} {'rmse':>7s} "
          f"{'clear':>7s} {'final_d p95':>11s} {'time':>12s}", flush=True)
    out = []
    for cap, cfg, use_cov in row_configs(base, caps):
        res, ms = fly(cfg, fleet, method, use_cov)
        fd = to_host(res.final_distance)
        r = {"cap": cap, "success": float(res.success.float().mean()),
             "crash": float(res.crashed.float().mean()),
             "rmse": float(res.tracking_rmse.mean()),
             "clearance": float(res.min_obstacle_clearance.mean()),
             "final_p95": float(np.percentile(fd, 95)), "ms": ms}
        print(f"{cap:5.1f} {r['success']:8.4f} {r['crash']:7.4f} {r['rmse']:7.4f} "
              f"{r['clearance']:7.3f} {r['final_p95']:11.3f} {ms:9.3f} ms ({label})",
              flush=True)
        out.append(r)

    # do uncapped crashes happen near unknown corridor samples?
    res0, ms = fly(base, fleet, method, use_cov=False)
    crashed = to_host(res0.crashed, bool)
    unk_any = (to_host(fleet.corridor) < UNKNOWN_BELOW).any(axis=1)
    check = {"crashes": int(crashed.sum()), "ms": ms,
             "with_unknown": float(unk_any[crashed].mean()) if crashed.any() else None,
             "base_rate": float(unk_any.mean())}
    if crashed.any():
        print("uncapped crash episodes: "
              f"{check['crashes']} total; with >=1 unknown corridor sample: "
              f"{check['with_unknown']:.3f} (fleet-wide base rate {check['base_rate']:.3f}) "
              f"({ms:.3f} ms, {label})", flush=True)
    return {"census": census, "rows": out, "uncapped": check}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="the device to fly on (default cuda; cpu runs the plain path)")
    ap.add_argument("--episodes", type=int, default=2048)
    ap.add_argument("--caps", type=str, default="0,5,4,3")
    ap.add_argument("--method", default="auto", choices=closed_loop.METHODS,
                    help="auto: kernels B1 and B2 on a card, the plain path on the CPU")
    # defaults = the shipped ClosedLoopConfig values (margin 1.5, coverage
    # 0.6), so a run with no flags reproduces the production setting
    ap.add_argument("--margin", type=float, default=1.5)
    ap.add_argument("--ramp", type=float, default=3.0)
    ap.add_argument("--coverage", type=float, default=0.6)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = script_device(ap, args.device)
    label = card_label(device)
    print(f"platform={device.type} ({label}) episodes={args.episodes}", flush=True)
    fleet = build_fleet(args.episodes, args.seed, device)
    caps = [float(c) for c in args.caps.split(",")]
    return rows(fleet, caps, args.method, base_config(args.margin, args.ramp, args.coverage),
                label)


if __name__ == "__main__":
    main()
