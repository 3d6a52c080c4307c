"""Convergence of the PyTorch port's solver on the bench batch (the port's
counterpart of scripts/diag_convergence.py, which imports JAX and stays).

Measures, on the bench.py batch (4096 randomized obstacle scenarios, 4 live
spheres, at ``--horizon`` N, default 20): the converged share and the cost
excess over a ground truth, a 60-round CG-25 solve of the plain path
(``method="torch"``) without the tail, as a function of the Newton and CG
budget (the uniform rows, single-phase), at the shipping configuration (the
two-phase solve) and with the perturbed restart (``restart_iterations=20``);
for the plain path (``torch``, the JAX script's ``xla``) and kernel B1
(``cuda``, its ``pallas``, on a card only). Each row carries its time: CUDA
events around the solve on a card, beside the card's name and power limit
as nvidia-smi gives them; the host clock on the CPU.

    python scripts/diag_convergence_torch.py                       # the card, N=20
    python scripts/diag_convergence_torch.py --horizon 100
    python scripts/diag_convergence_torch.py --device cpu --quick --batch 32

Without a card it exits non-zero unless ``--device cpu`` is given. Imports
the port only.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dart_planner_tpu_torch.common.device import card_label, to_host  # noqa: E402
from dart_planner_tpu_torch.planning import se3_mpc  # noqa: E402

# the fixed uniform budgets (Newton rounds, CG iterations) of the JAX script
UNIFORM_BUDGETS = ((12, 10), (16, 10), (20, 10), (24, 10))
COLUMNS = ("method", "budget", "conv", "p95 excess", "max excess", "conv-cohort p95")


def make_batch(batch: int = 4096, seed: int = 0, horizon: int = 20, device="cuda"):
    """The JAX script's batch (the same numpy draws) at ``horizon`` steps,
    on ``device``: (config, problem)."""
    rng = np.random.default_rng(seed)
    config = se3_mpc.SE3MPCConfig(prediction_horizon=horizon)
    obs = np.concatenate(
        [rng.normal(0, 4, (batch, 4, 3)), rng.uniform(0.3, 1.2, (batch, 4, 1))], axis=-1,
    ).astype(np.float32)
    prob = se3_mpc.make_problem(
        rng.normal(0, 2, (batch, 3)).astype(np.float32) + [0, 0, 5],
        rng.normal(0, 1, (batch, 3)).astype(np.float32),
        rng.normal(0, 5, (batch, 3)).astype(np.float32) + [0, 0, 5],
        obstacles=obs, config=config, device=device,
    )
    return config, prob


def timed(fn, device):
    """``fn()`` and its time in ms: CUDA events around it on a card, the
    host clock on the CPU."""
    if torch.device(device).type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = fn()
    return out, 1e3 * (time.perf_counter() - t0)


def script_device(ap: argparse.ArgumentParser, name: str) -> torch.device:
    """``--device`` of a diagnostic: a card (the default) or the CPU. Without
    a card, ``ap.error`` (exit 2) names ``--device cpu``; nothing falls back
    to the CPU unasked. TF32 is turned off: the plain paths' reference
    arithmetic is exact float32."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu to run the plain path on the CPU")
    if device.type not in ("cuda", "cpu"):
        ap.error(f"--device {name}: a card (cuda) or the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device


def methods_on(device) -> list:
    """The solve paths of a row: the plain path (the JAX scripts' ``xla``)
    and kernel B1 (``cuda``, their ``pallas``) on a card, the plain path
    alone on the CPU."""
    return ["torch", "cuda"] if torch.device(device).type == "cuda" else ["torch"]


def run(config, prob, method: str, **overrides):
    """One solve from the cold start; returns (result, ms): CUDA events
    around it on a card, the host clock on the CPU."""
    cfg = config._replace(**overrides)
    u0 = se3_mpc.initialize_thrusts(cfg, prob)
    return timed(lambda: se3_mpc.solve(cfg, prob, u0, method=method), prob.p0.device)


def ground_truth(config, prob):
    """A long float32 solve of the plain path (single-phase): 60 rounds at
    CG-25."""
    return run(config, prob, "torch", max_iterations=60, cg_iterations=25, tail_iterations=0)


def excess_over(cost, gt_cost: np.ndarray) -> np.ndarray:
    """The relative cost excess over the ground truth, in float64 on the
    host: (cost - gt) / max(|gt|, 1e-9)."""
    cost = to_host(cost)
    return (cost - gt_cost) / np.maximum(np.abs(gt_cost), 1e-9)


def excess_row(method: str, label: str, res, gt_cost: np.ndarray, ms: float) -> dict:
    """The JAX script's columns for one solve: its converged share, the p95
    and max of its cost excess over the ground truth, and the p95 of the
    converged cohort's excess (the honesty of the ftol gate)."""
    excess = excess_over(res.cost, gt_cost)
    conv = res.converged.cpu().numpy()
    return {"method": method, "budget": label, "conv": float(conv.mean()),
            "p95": float(np.percentile(excess, 95)), "max": float(excess.max()),
            "conv_p95": float(np.percentile(excess[conv], 95)) if conv.any() else float("nan"),
            "ms": ms}


def rows(config, prob, gt_cost: np.ndarray, methods, quick: bool):
    """The JAX script's rows for each method: the uniform budgets unless
    ``quick``, the ship row and the ship + restart row."""
    for method in methods:
        for newton, cg in ([] if quick else UNIFORM_BUDGETS):
            res, ms = run(config, prob, method, max_iterations=newton, cg_iterations=cg,
                          tail_iterations=0)
            yield excess_row(method, f"uniform {newton}/{cg}", res, gt_cost, ms)
        res, ms = run(config, prob, method)
        yield excess_row(method, f"ship {config.max_iterations}+{config.tail_iterations}"
                                 f"@{config.tail_cg_iterations}", res, gt_cost, ms)
        res, ms = run(config, prob, method, restart_iterations=20)
        yield excess_row(method, "ship+restart 20", res, gt_cost, ms)


def format_row(r: dict, label: str) -> str:
    return (f"{r['method']:8s} {r['budget']:>16s} {r['conv']:7.4f} {r['p95']:11.2e} "
            f"{r['max']:11.2e} {r['conv_p95']:15.2e} {r['ms']:10.3f} ms ({label})")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="the device to solve on (default cuda; cpu runs the plain path only)")
    ap.add_argument("--horizon", type=int, default=20, help="prediction horizon N")
    ap.add_argument("--torch-only", action="store_true",
                    help="the plain path only (the JAX script's --xla-only)")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--quick", action="store_true",
                    help="skip the uniform-budget rows (ship rows only)")
    args = ap.parse_args(argv)
    device = script_device(ap, args.device)
    label = card_label(device)

    config, prob = make_batch(args.batch, horizon=args.horizon, device=device)
    print(f"platform={device.type} ({label}) batch={args.batch} horizon={args.horizon}",
          flush=True)
    gt, ms = ground_truth(config, prob)
    gt_cost = gt.cost.double().cpu().numpy()
    print(f"ground truth: conv={float(gt.converged.float().mean()):.4f} "
          f"median cost={np.median(gt_cost):.3f} in {ms:.3f} ms ({label})", flush=True)
    print(f"{COLUMNS[0]:8s} {COLUMNS[1]:>16s} {COLUMNS[2]:>7s} {COLUMNS[3]:>11s} "
          f"{COLUMNS[4]:>11s} {COLUMNS[5]:>15s} {'time':>13s}", flush=True)
    methods = ["torch"] if args.torch_only else methods_on(device)
    out = []
    for r in rows(config, prob, gt_cost, methods, args.quick):
        print(format_row(r, label), flush=True)
        out.append(r)
    return {"ground_truth": gt_cost, "rows": out, "device": label}


if __name__ == "__main__":
    main()
