"""A curvature-aware convergence criterion, the Newton decrement, on the
PyTorch port's solver (the port's counterpart of
scripts/diag_newton_decrement.py, which imports JAX and stays).

The projected-gradient norm saturates on hinge-dominated scenarios:
gradients near an active hinge boundary are O(weight) even where the cost
can barely improve. This script measures the diagonal-preconditioned Newton
decrement

    lambda^2 / 2 = 0.5 * sum(pg^2 / diag(H))   (predicted improvement)

relative to (1 + cost), at several Newton budgets, against the observed cost
excess over a ground truth: the plain path (``method="torch"``) at 60
rounds of CG-25, keeping the JAX script's 8-round tail. The decrement is
computed in exact float32 (TF32 off). Each budget runs on the plain path
and, on a card, on kernel B1 (``cuda``); each row carries its solve's time,
CUDA events on a card beside the card's name and power limit as nvidia-smi
gives them, the host clock on the CPU.

    python scripts/diag_newton_decrement_torch.py                  # the card, N=20
    python scripts/diag_newton_decrement_torch.py --horizon 100
    python scripts/diag_newton_decrement_torch.py --device cpu --batch 32

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

from dart_planner_tpu_torch.common import frames  # noqa: E402
from dart_planner_tpu_torch.common.device import card_label, to_host  # noqa: E402
from dart_planner_tpu_torch.ops import costs, dynamics  # noqa: E402

from diag_convergence_torch import (  # noqa: E402
    excess_over, make_batch, methods_on, run, script_device,
)

BUDGETS = (12, 14, 16, 20)
TOLERANCES = (1e-4, 1e-5, 1e-6)
PERCENTILES = (50, 90, 95, 99)


def gravity(config, u):
    return frames.gravity_vector(frames.WorldFrame.ENU, config.gravity, dtype=u.dtype,
                                 device=u.device)


def projected_gradient(config, prob, u):
    """``clip(u - grad, lb, ub) - u``: the projected-gradient step of
    thrusts ``u`` (..., N, 3)."""
    lb, ub = config.thrust_bounds(u.dtype, u.device)
    g = costs.condensed_grad(u, prob, config.weights, config.dt, config.mass,
                             gravity(config, u))
    return torch.clamp(u - g, lb, ub) - u


def decrement_terms(config, prob, u):
    """The parts of the decrement at thrusts ``u`` (..., N, 3): the
    projected gradient, the Hessian's diagonal (each (..., N, 3)) and the
    cost J(u) (...)."""
    N = config.prediction_horizon
    dt, mass, w = config.dt, config.mass, config.weights
    kw = dict(dtype=u.dtype, device=u.device)
    gvec = gravity(config, u)
    pg = projected_gradient(config, prob, u)

    H_axis = torch.as_tensor(costs.quadratic_hessian(N, dt, mass, config.gravity, w), **kw)
    diag = torch.diagonal(H_axis)[:, None].expand(N, 3)
    Hp, Hv, Hu = costs.penalty_blocks(u, prob, w, dt, mass, gvec, include_obstacles=True)
    S_p, S_v, _ = dynamics.rollout_matrices(N, float(dt))
    Sp = torch.as_tensor(S_p, **kw) / mass
    Sv = torch.as_tensor(S_v, **kw) / mass
    Hp_diag = torch.diagonal(Hp, dim1=-2, dim2=-1)
    diag = diag + torch.einsum("ki,...ka->...ia", Sp * Sp, Hp_diag)
    diag = diag + torch.einsum("ki,...ka->...ia", Sv * Sv, Hv)
    if Hu is not None:
        diag = diag + torch.diagonal(Hu, dim1=-2, dim2=-1)

    return pg, torch.clamp(diag, min=1e-8), costs.condensed_cost(u, prob, w, dt, mass, gvec)


def newton_decrement(config, prob, u):
    """0.5 * pg^T diag(H)^-1 pg / (1 + |cost|): the relative predicted
    improvement of one diagonal-preconditioned projected step, and the
    cost J(u). Returns (decrement, cost), each (...)."""
    pg, diag, cost = decrement_terms(config, prob, u)
    return 0.5 * (pg * pg / diag).sum((-1, -2)) / (1.0 + cost.abs()), cost


def ground_truth(config, prob):
    """The JAX script's ground truth: 60 rounds at CG-25 on the plain path,
    the 8-round tail kept. Returns (result, ms)."""
    return run(config, prob, "torch", max_iterations=60, cg_iterations=25)


def rows(config, prob, gt_cost: np.ndarray, methods):
    """For each method and Newton budget (the tail kept), the share of
    scenarios whose decrement is below each tolerance, the cost excess
    (p95, max) and the largest excess in that converged cohort."""
    for method in methods:
        for newton in BUDGETS:
            cfg = config._replace(max_iterations=newton)
            res, ms = run(cfg, prob, method)
            nd, cost = newton_decrement(cfg, prob, res.thrusts)
            nd = to_host(nd)
            excess = excess_over(cost, gt_cost)
            for tol in TOLERANCES:
                conv = nd < tol
                yield {"method": method, "newton": newton, "tol": tol,
                       "conv": float(conv.mean()), "p95": float(np.percentile(excess, 95)),
                       "max": float(excess.max()),
                       "conv_max": float(excess[conv].max()) if conv.any() else 0.0,
                       "ms": ms}


def format_row(r: dict, label: str) -> str:
    return (f"{r['method']:5s} newton={r['newton']:2d} tol={r['tol']:.0e}: conv={r['conv']:.4f} "
            f"| excess p95={r['p95']:.2e} max={r['max']:.2e} "
            f"| excess among CONVERGED max={r['conv_max']:.2e} "
            f"| solve {r['ms']:.3f} ms ({label})")


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
    gt_cost = to_host(gt.cost)
    nd_gt = to_host(newton_decrement(config._replace(max_iterations=60, cg_iterations=25),
                                     prob, gt.thrusts)[0])
    pct = [float(np.percentile(nd_gt, p)) for p in PERCENTILES]
    print("GT newton-decrement percentiles 50/90/95/99:", [f"{p:.2e}" for p in pct],
          f"(ground truth {ms:.3f} ms, {label})", flush=True)
    out = []
    for r in rows(config, prob, gt_cost, methods_on(device)):
        print(format_row(r, label), flush=True)
        out.append(r)
    return {"gt_percentiles": pct, "rows": out, "device": label}


if __name__ == "__main__":
    main()
