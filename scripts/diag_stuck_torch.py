"""Anatomy of the stuck scenario on the PyTorch port (the port's counterpart
of scripts/diag_stuck.py, which imports JAX and stays).

One scenario of the bench batch ends the shipping solve far above its
ground truth (ROADMAP C, reference fault 11: a round with no cheaper
candidate, which the ftol rule counts as converged). For each solve path
this probe answers:

  1. which scenario it is (and the next worst), and whether the restart's
     suspicion ranking (cost over the quadratic floor of the cold start)
     selects it at capacity 1/32;
  2. from jittered starts at noise 0, 1, 2, 4 and 8 N (a fifth of
     ``--batch`` tiled copies of the scenario each, the last scale padded
     to the edge), what share of the shipping solves reach within 5% of
     its ground truth.

The ground truth is the JAX script's: the plain path at 60 rounds of CG-25
without the tail. The jitter is drawn on a CPU ``torch.Generator`` seeded
1 (``jax.random``'s draws cannot be reproduced in torch). Each solve runs on
the plain path and, on a card, on kernel B1 (``cuda``), with its time: CUDA
events on a card beside the card's name and power limit as nvidia-smi gives
them, the host clock on the CPU.

    python scripts/diag_stuck_torch.py                  # the card, N=20, B=4096
    python scripts/diag_stuck_torch.py --device cpu --batch 32

Without a card it exits non-zero unless ``--device cpu`` is given. Imports
the port only.
"""

from __future__ import annotations

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dart_planner_tpu_torch.common.device import card_label, to_host  # noqa: E402
from dart_planner_tpu_torch.ops import costs  # noqa: E402
from dart_planner_tpu_torch.planning import se3_mpc  # noqa: E402

from diag_convergence_torch import (  # noqa: E402
    excess_over, ground_truth, make_batch, methods_on, script_device, timed,
)
from diag_newton_decrement_torch import gravity  # noqa: E402

NOISE_SCALES = (0.0, 1.0, 2.0, 4.0, 8.0)
COHORT_FRACTION = 1.0 / 32.0
JITTER_SEED = 1
WORST = 5  # the worst-excess scenarios listed beside the probed one


def suspicion_ratio(config, prob, u0, cost) -> np.ndarray:
    """cost / max(quadratic floor, 1e-3) per scenario: the floor is the
    cost of the cold start ``u0`` with every hinge weight zeroed."""
    w_quad = config.weights._replace(obstacle=0.0, ground=0.0, velocity_bound=0.0, tilt=0.0,
                                     thrust_norm=0.0)
    quad = to_host(costs.condensed_cost(u0, prob, w_quad, config.dt, config.mass,
                                        gravity(config, u0)))
    return to_host(cost) / np.maximum(quad, 1e-3)


def cohort(ratio: np.ndarray, i: int) -> tuple:
    """(rank of scenario ``i`` by suspicion, 0 = most suspicious; the
    restart cohort's size at capacity 1/32; whether ``i`` is in it)."""
    rank = int(np.sum(ratio > ratio[i]))
    size = int(math.ceil(ratio.size * COHORT_FRACTION))
    return rank, size, rank < size


def tiled(prob, i: int, batch: int):
    """``batch`` copies of scenario ``i`` (expanded views, no velocity cap)."""
    def tile(x):
        return x[i][None].expand((batch,) + tuple(x.shape[1:]))
    return costs.Problem(p0=tile(prob.p0), v0=tile(prob.v0), goal=tile(prob.goal),
                         obstacles=tile(prob.obstacles),
                         obstacle_mask=tile(prob.obstacle_mask), v_cap=None)


def noise_scales(batch: int) -> np.ndarray:
    """The jitter's std per copy: a fifth of the batch at each scale, the
    last padded to the edge."""
    s = np.repeat(NOISE_SCALES, batch // len(NOISE_SCALES))
    return np.pad(s, (0, batch - s.size), mode="edge")


def jitter_census(config, prob, i: int, gt_i: float, method: str, generator) -> dict:
    """The shipping solve of ``prob.p0.shape[0]`` tiled copies of scenario
    ``i`` from its cold start plus Gaussian jitter (``noise_scales``); per
    scale, the share within 5% of ``gt_i``, the best and the median cost."""
    batch = prob.p0.shape[0]
    prob_t = tiled(prob, i, batch)
    u_qp = se3_mpc.initialize_thrusts(config, prob_t)
    scales = noise_scales(batch)
    noise = torch.randn(u_qp.shape, generator=generator, dtype=u_qp.dtype) * torch.as_tensor(
        scales, dtype=u_qp.dtype)[:, None, None]
    u_init = u_qp + noise.to(u_qp.device)
    res, ms = timed(lambda: se3_mpc.solve(config, prob_t, u_init, method=method),
                    prob.p0.device)
    cj = to_host(res.cost)
    good = cj <= gt_i * 1.05
    return {"good": float(good.mean()), "ms": ms,
            "scales": [{"std": s, "good": float(good[scales == s].mean()),
                        "best": float(cj[scales == s].min()),
                        "median": float(np.median(cj[scales == s]))} for s in NOISE_SCALES]}


def probe(config, prob, gt_cost: np.ndarray, method: str) -> dict:
    """Parts 1 and 2 for one method: the worst-excess scenario of the
    shipping solve, its suspicion rank and cohort, and its jitter census."""
    u0 = se3_mpc.initialize_thrusts(config, prob)
    res, ms = timed(lambda: se3_mpc.solve(config, prob, u0, method=method), prob.p0.device)
    cost = to_host(res.cost)
    excess = excess_over(cost, gt_cost)
    i = int(np.argmax(excess))
    conv = to_host(res.converged, bool)
    worst = [(int(j), float(excess[j]), bool(conv[j])) for j in np.argsort(-excess)[:WORST]]
    ratio = suspicion_ratio(config, prob, u0, cost)
    rank, size, member = cohort(ratio, i)
    census = jitter_census(config, prob, i, float(gt_cost[i]), method,
                           torch.Generator().manual_seed(JITTER_SEED))
    live = to_host(prob.obstacle_mask, bool)[i]
    return {"method": method, "scenario": i, "excess": float(excess[i]), "cost": float(cost[i]),
            "gt": float(gt_cost[i]), "converged": bool(conv[i]), "ms": ms, "worst": worst,
            "p0": to_host(prob.p0)[i], "goal": to_host(prob.goal)[i],
            "obstacles": [[round(float(v), 2) for v in o] for o in to_host(prob.obstacles)[i][live]],
            "ratio": float(ratio[i]), "rank": rank, "cohort_size": size, "in_cohort": member,
            "ratio_p50": float(np.median(ratio)), "ratio_p99": float(np.percentile(ratio, 99)),
            "census": census}


def report(r: dict, label: str) -> None:
    m = r["method"]
    print(f"[{m}] stuck scenario #{r['scenario']}: excess={r['excess']:.3f} "
          f"cost={r['cost']:.1f} gt={r['gt']:.1f} converged={r['converged']} "
          f"(solve {r['ms']:.3f} ms, {label})")
    print(f"[{m}]   the {len(r['worst'])} worst (scenario, excess, converged): "
          + ", ".join(f"#{j} {e:.3g} {c}" for j, e, c in r["worst"]))
    print(f"[{m}]   p0={r['p0']} goal={r['goal']}")
    print(f"[{m}]   obstacles (masked r_safe): {r['obstacles']}")
    print(f"[{m}]   suspicion ratio={r['ratio']:.3f} rank={r['rank']} "
          f"(cohort size {r['cohort_size']}; {'IN' if r['in_cohort'] else 'NOT IN'} cohort)  "
          f"ratio p50={r['ratio_p50']:.3f} p99={r['ratio_p99']:.3f}")
    c = r["census"]
    print(f"[{m}]   jittered starts reaching within 5% of gt (gt={r['gt']:.1f}): "
          f"{c['good']:.3f} overall (solve {c['ms']:.3f} ms, {label})")
    for s in c["scales"]:
        print(f"[{m}]     noise std {s['std']:4.1f} N: good={s['good']:.3f} "
              f"best={s['best']:.1f} median={s['median']:.1f}", flush=True)


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
    print(f"ground truth (60 rounds of CG-25, no tail, plain path) in {ms:.3f} ms ({label})",
          flush=True)
    out = []
    for method in methods_on(device):
        r = probe(config, prob, to_host(gt.cost), method)
        report(r, label)
        out.append(r)
    return {"rows": out, "device": label}


if __name__ == "__main__":
    main()
