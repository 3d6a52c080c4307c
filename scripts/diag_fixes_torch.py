"""A/B of the candidate tail-convergence fixes on the PyTorch port's bench
batch (the port's counterpart of scripts/diag_fixes.py, which imports JAX
and stays).

Each variant of the JAX script (the same names and overrides of the
shipping ``SE3MPCConfig``): the converged share by the ftol criterion and
the p95 and max cost excess over the JAX script's ground truth (the plain
path at 60 rounds of CG-25, the tail kept). Each variant runs on the plain
path and, on a card, on kernel B1 (``cuda``); each row carries its solve's
time where the JAX script printed compile plus run: CUDA events on a card
beside the card's name and power limit as nvidia-smi gives them, the host
clock on the CPU.

    python scripts/diag_fixes_torch.py                  # the card, N=20, B=4096
    python scripts/diag_fixes_torch.py --device cpu --batch 32

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

from diag_convergence_torch import (  # noqa: E402
    excess_over, make_batch, methods_on, run, script_device,
)
from diag_newton_decrement_torch import ground_truth  # noqa: E402
from diag_tail_torch import WIDE  # noqa: E402

VARIANTS = {
    "base-12": {},
    "base-16": {"max_iterations": 16},
    "fullH-12": {"newton_full_curvature": True},
    "fullH-16": {"newton_full_curvature": True, "max_iterations": 16},
    "wideLS-12": {"line_search_alphas": WIDE},
    "fullH+wideLS-12": {"newton_full_curvature": True, "line_search_alphas": WIDE},
    "fullH+wideLS-16": {"newton_full_curvature": True, "line_search_alphas": WIDE,
                        "max_iterations": 16},
}


def rows(config, prob, gt_cost: np.ndarray, methods):
    """Each variant for each method: its converged share and cost excess."""
    for method in methods:
        for name, over in VARIANTS.items():
            res, ms = run(config, prob, method, **over)
            excess = excess_over(res.cost, gt_cost)
            yield {"method": method, "variant": name,
                   "conv": float(res.converged.float().mean()),
                   "p95": float(np.percentile(excess, 95)), "max": float(excess.max()),
                   "ms": ms}


def format_row(r: dict, label: str) -> str:
    return (f"{r['method']:5s} {r['variant']:18s} conv={r['conv']:.4f} p95ex={r['p95']:.2e}"
            f" maxex={r['max']:.2e} (solve {r['ms']:.3f} ms, {label})")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="the device to solve on (default cuda; cpu runs the plain path only)")
    ap.add_argument("--batch", type=int, default=4096)
    args = ap.parse_args(argv)
    device = script_device(ap, args.device)
    label = card_label(device)

    config, prob = make_batch(args.batch, device=device)
    print(f"platform={device.type} ({label}) batch={args.batch} horizon={config.prediction_horizon}",
          flush=True)
    gt, ms = ground_truth(config, prob)
    print(f"gt done in {ms:.3f} ms ({label})", flush=True)
    out = []
    for r in rows(config, prob, to_host(gt.cost), methods_on(device)):
        print(format_row(r, label), flush=True)
        out.append(r)
    return {"rows": out, "device": label}


if __name__ == "__main__":
    main()
