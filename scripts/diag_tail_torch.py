"""The slowly converging solver tail on the PyTorch port: how much of its
projected gradient sits on thrust bounds, how many of its scenarios are
inside a hinge, how its cost falls with the round count, and how it answers
other line-search grids (the port's counterpart of scripts/diag_tail.py,
which imports JAX and stays).

The tail is the scenarios whose Newton decrement
(:func:`diag_newton_decrement_torch.newton_decrement`) passes 1e-5 after the
shipping solve (12 rounds, then the 8-round tail). The ground truth is the
JAX script's: the plain path at 60 rounds of CG-25, the tail kept. The
hinge-active count mirrors a quirk of the JAX script: it adds
``config.safety_margin`` to radii that ``make_problem`` has inflated by that
margin already, so "inside" means within twice the margin of a sphere's
surface. Each solve runs on the plain path and, on a card, on kernel B1
(``cuda``; the wide grid is 12 alphas, the over-relaxed 8); each row
carries its time, CUDA events on a card beside the card's name and power
limit as nvidia-smi gives them, the host clock on the CPU.

    python scripts/diag_tail_torch.py                  # the card, N=20, B=4096
    python scripts/diag_tail_torch.py --device cpu --batch 32

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
import torch  # noqa: E402

from dart_planner_tpu_torch.common.device import card_label, to_host  # noqa: E402

from diag_convergence_torch import (  # noqa: E402
    excess_over, make_batch, methods_on, run, script_device,
)
from diag_newton_decrement_torch import (  # noqa: E402
    ground_truth, newton_decrement, projected_gradient,
)

TAIL_TOL = 1e-5
ROUNDS = (12, 16, 20, 28, 40)
WIDE = (1.5, 1.0, 0.7, 0.5, 0.35, 0.25, 0.15, 0.1, 0.06, 0.03, 0.015, 0.007)
OVERRELAX = (4.0, 2.0, 1.0, 0.5, 0.25, 0.1, 0.03, 0.01)


def grids(config) -> dict:
    """The JAX script's line-search grids, by name."""
    return {"default(6)": tuple(config.line_search_alphas), "wide(12)": WIDE,
            "overrelax(8)": OVERRELAX}


def bound_share(config, prob, u) -> np.ndarray:
    """Per scenario, the share of |pg|^2 on coordinates within 1e-2 of a
    thrust bound."""
    lb, ub = config.thrust_bounds(u.dtype, u.device)
    pg2 = projected_gradient(config, prob, u) ** 2
    near = ((u <= lb + 1e-2) | (u >= ub - 1e-2)).to(pg2.dtype)
    return to_host((pg2 * near).sum((-1, -2))) / np.maximum(to_host(pg2.sum((-1, -2))), 1e-12)


def hinge_active(config, prob, positions) -> np.ndarray:
    """Per scenario, whether a planned position lies inside a live sphere's
    radius plus ``config.safety_margin`` (the radii of ``prob`` carry the
    margin already: the JAX script's double margin, kept)."""
    pos, obs, mask = to_host(positions), to_host(prob.obstacles), to_host(prob.obstacle_mask, bool)
    d = np.linalg.norm(pos[:, None, :, :] - obs[:, :, None, :3], axis=-1)
    inflated = obs[:, :, 3:4] + config.safety_margin
    return ((d < inflated) & mask[:, :, None]).any(axis=(1, 2))


def _pcts(x: np.ndarray, *ps) -> list:
    return [float(np.percentile(x, p)) if x.size else float("nan") for p in ps]


def rows(config, prob, gt_cost: np.ndarray, method: str) -> dict:
    """The JAX script's three parts for one method: (a) the tail share after
    the shipping solve, its near-bound share of |pg|^2 and the hinge-active
    shares; (b) the tail's cost excess by round count; (c) the line-search
    grids at the shipping budget."""
    res, ms = run(config, prob, method)
    tail = to_host(newton_decrement(config, prob, res.thrusts)[0]) > TAIL_TOL
    share = bound_share(config, prob, res.thrusts)
    inside = hinge_active(config, prob, res.positions)
    out = {"method": method, "tail": float(tail.mean()), "ms": ms,
           "bound_p50_p90": _pcts(share[tail], 50, 90),
           "inside_tail": float(inside[tail].mean()) if tail.any() else float("nan"),
           "inside_converged": float(inside[~tail].mean()) if (~tail).any() else float("nan"),
           "rounds": [], "grids": []}
    for k in ROUNDS:
        r, ms_k = run(config, prob, method, max_iterations=k)
        excess = excess_over(r.cost, gt_cost)[tail]
        out["rounds"].append({"iters": k, "median": _pcts(excess, 50)[0],
                              "p95": _pcts(excess, 95)[0], "ms": ms_k})
    for name, grid in grids(config).items():
        cfg = config._replace(line_search_alphas=tuple(grid))
        r, ms_g = run(cfg, prob, method)
        nd = to_host(newton_decrement(cfg, prob, r.thrusts)[0])
        out["grids"].append({"grid": name, "conv_ftol": float(r.converged.float().mean()),
                             "conv_nd": float((nd < TAIL_TOL).mean()),
                             "p95": float(np.percentile(excess_over(r.cost, gt_cost), 95)),
                             "ms": ms_g})
    return out


def report(r: dict, label: str) -> None:
    m = r["method"]
    print(f"[{m}] tail fraction at 12 iters: {r['tail']:.4f} (solve {r['ms']:.3f} ms, {label})")
    p50, p90 = r["bound_p50_p90"]
    print(f"[{m}] tail: |pg|^2 fraction on near-bound coords p50/p90: {p50:.3f} {p90:.3f}")
    print(f"[{m}] hinge-active (inside margin) fraction: tail={r['inside_tail']:.3f} "
          f"converged={r['inside_converged']:.3f}")
    print(f"[{m}] iters  tail-median-excess  tail-p95-excess  time")
    for k in r["rounds"]:
        print(f"[{m}] {k['iters']:5d}  {k['median']:.3e}          {k['p95']:.3e}"
              f"        {k['ms']:.3f} ms")
    for g in r["grids"]:
        print(f"[{m}] grid {g['grid']:13s}: conv(ftol)={g['conv_ftol']:.4f} "
              f"conv(nd<1e-5)={g['conv_nd']:.4f} p95 excess={g['p95']:.2e} "
              f"({g['ms']:.3f} ms)", flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="the device to solve on (default cuda; cpu runs the plain path only)")
    ap.add_argument("--horizon", type=int, default=20, help="prediction horizon N")
    ap.add_argument("--batch", type=int, default=4096)
    args = ap.parse_args(argv)
    device = script_device(ap, args.device)
    label = card_label(device)

    config, prob = make_batch(args.batch, horizon=args.horizon, device=device)
    print(f"platform={device.type} ({label}) batch={args.batch} horizon={args.horizon}",
          flush=True)
    gt, ms = ground_truth(config, prob)
    print(f"ground truth (60 rounds of CG-25, the tail kept, plain path) in {ms:.3f} ms "
          f"({label})", flush=True)
    out = []
    for method in methods_on(device):
        r = rows(config, prob, to_host(gt.cost), method)
        report(r, label)
        out.append(r)
    return {"rows": out, "device": label}


if __name__ == "__main__":
    main()
