"""The comparisons that decide ``correct``: what the timed path produced,
recorded by the benchmark, against this folder's plain references, on the
same generated inputs. Every function returns plain numbers by name; the
configuration's ``limits`` say which of them are compared and against
what. Imports nothing of the program, of JAX or of the JAX package.

Gaps are widest absolute differences in the quantity's own unit (m, m/s,
m/s^2, rad, rad/s, N, s); a relative cost gap is over ``1 + |cost|``. A
solve's *excess* is how far the program's plan costs above the reference's
plan from the same warm start, both costs evaluated in float64:
``(J(u_prog) - J(u_ref)) / (1 + J(u_ref))``. Both solvers run the same
fixed budget and part at branch points of the Newton path (a line search
that ties in float32), so single scenarios land in other basins either
way; the excess is read as shares and quantiles over many scenarios.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import loop as ref_loop
from benchmark.reference import solve as ref

Tensor = torch.Tensor
EXCESS_LEVEL = 1e-3  # an excess above this counts toward excess_share
# the quantile of the tick blocks' per-episode gaps that tick_gap reads: a
# rare block parts at a branch of the controller (the tilt limit, the
# small-angle rotation) by up to ~1e-3 on some seeds, a thousandth of them
# do not
TICK_QUANTILE = 0.999
OUTCOME_FLIP = 1.0  # the gap an outcome flag that disagrees with its metrics reads


def _max(x: Tensor) -> float:
    return float(x.abs().max()) if x.numel() else 0.0


def _f64(prob: ref.Problem) -> ref.Problem:
    return ref.Problem(*[None if x is None else (x.double() if x.is_floating_point() else x)
                         for x in prob])


def plan_consistency(c: ref.SolverConfig, prob: ref.Problem, thrusts, positions, velocities,
                     accelerations, cost) -> tuple[float, float, Tensor]:
    """How far a plan's states and cost lie from its own thrusts' float64
    rollout and cost: (state gap, relative cost gap, float64 cost)."""
    p64 = _f64(prob)
    u = thrusts.double()
    pos, vel, acc = ref.rollout(c, u, p64.p0, p64.v0)
    state = max(_max(positions.double() - pos), _max(velocities.double() - vel),
                _max(accelerations.double() - acc))
    J = ref.cost(c, p64, u)
    return state, _max((cost.double() - J) / (1.0 + J.abs())), J


def excess_stats(prefix: str, J_prog: Tensor, J_ref: Tensor) -> dict:
    """Quantiles of the per-scenario excess, its mean and largest value,
    and the share of scenarios above EXCESS_LEVEL."""
    ex = ((J_prog - J_ref) / (1.0 + J_ref.abs())).cpu().numpy()
    out = {f"{prefix}_share": float(np.mean(ex > EXCESS_LEVEL)),
           f"{prefix}_mean": float(np.mean(ex)), f"{prefix}_max": float(np.max(ex))}
    for q in (50, 90, 99):
        out[f"{prefix}_p{q}"] = float(np.quantile(ex, q / 100))
    return out


def fleet(c: ref.SolverConfig, inp: dict, records: list) -> dict:
    """The fleet's replans: each record holds the pool index ``k`` of the
    replan's states, the thrusts of the replan before it (``u_prev``), and
    what the replan produced (``thrusts``, ``positions``, ``velocities``,
    ``accelerations``, ``cost``, ``converged``, and the extracted
    ``attitudes``, ``body_rates``, ``thrust_norms``, ``timestamps``)."""
    state = cost_gap = extract_gap = 0.0
    mismatch, share, J_prog, J_ref = [], [], [], []
    for r in records:
        k = r["k"]
        prob = ref.make_problem(c, inp["positions"][k], inp["velocities"][k], inp["goal"],
                                inp["obstacles"])
        s, cg, J = plan_consistency(c, prob, r["thrusts"], r["positions"], r["velocities"],
                                    r["accelerations"], r["cost"])
        state, cost_gap = max(state, s), max(cost_gap, cg)
        att, rates, tmag, ts = ref.extract(c, r["thrusts"].double(),
                                           inp["timestamps"][k].double())
        extract_gap = max(extract_gap, _max(r["attitudes"].double() - att),
                          _max(r["body_rates"].double() - rates),
                          _max(r["thrust_norms"].double() - tmag),
                          _max(r["timestamps"].double() - ts))
        res = ref.solve(c, prob, ref.shift(r["u_prev"]))
        J_prog.append(J)
        J_ref.append(ref.cost(c, _f64(prob), res.thrusts.double()))
        mismatch.append((r["converged"] != res.converged).double().mean().item())
        share.append(abs(r["converged"].double().mean().item()
                         - res.converged.double().mean().item()))
        del res
    out = {"state_gap": state, "cost_gap": cost_gap, "extract_gap": extract_gap,
           "converged_gap": max(mismatch), "converged_share_gap": max(share)}
    out.update(excess_stats("excess", torch.cat(J_prog), torch.cat(J_ref)))
    return out


def closed_loop(loop: dict, c: ref.SolverConfig, ctrl: dict, plant: dict, inp: dict,
                blocks: list, result: dict, rows: Tensor) -> dict:
    """The closed loop's replans, followed from the program's own state:
    each block of ``blocks`` holds the problem handed to the solve (``p0``,
    ``v0``, ``obstacles``, ``mask``, ``v_cap``, ``u_init``), the plan it
    returned (``thrusts``, ``positions``, ``velocities``, ``accelerations``,
    ``cost``), the setpoint rows (``spp``, ``spv``, ``spa``) and the tick
    block's rows (``S_in``, ``gw``, ``obs_rows``, ``S_out``, ``acc``);
    ``result`` is the episodes' outcome. The plans, setpoints and ticks are
    checked on the episodes ``rows``; the chaining of the state from block
    to block and the outcomes on every episode.

    - glue_gap: the first block's state against vehicles at rest at the
      starts; each block's state against the last block's output; each
      problem, warm start, goal-and-wind and sphere rows against the
      reference's from the same state; the setpoints against the
      reference's interpolation of the program's plan.
    - plan_gap, plan_cost_gap: each plan against its thrusts' float64
      rollout and cost; plan_excess_*: against the reference's solve of the
      same problem from the same warm start.
    - tick_gap: the larger of the TICK_QUANTILE quantile over the sampled
      episodes' blocks of each block's widest gap against the reference's
      ticks from the same state, setpoints, wind and spheres, and the
      widest gap of every episode's outcome against the reference's reading
      of the program's own metric rows (a flag that disagrees reads
      OUTCOME_FLIP).
    """
    glue = ref_loop.Glue(loop, c, inp)
    T, dt = int(loop["substeps_per_plan"]), float(loop["control_dt"])
    glue_gap = _max(blocks[0]["S_in"][:, rows] - ref_loop.initial_rows(inp["starts"][rows], ctrl))
    glue_gap = max(glue_gap, _max(blocks[0]["gw"] - glue.goal_wind(inp["wind"])),
                   _max(blocks[0]["obs_rows"] - glue.sphere_rows()))
    hover = torch.tensor([0.0, 0.0, c.mass * c.gravity], dtype=torch.float32,
                         device=rows.device).expand(len(rows), c.prediction_horizon, 3)
    plan_gap = plan_cost = 0.0
    probs, u_inits, J_prog = [], [], []
    for b, blk in enumerate(blocks):
        if b > 0:
            glue_gap = max(glue_gap, _max(blk["S_in"] - blocks[b - 1]["S_out"]),
                           _max(blk["gw"] - blocks[0]["gw"]),
                           _max(blk["obs_rows"] - blocks[0]["obs_rows"]))
        S = blk["S_in"][:, rows]
        prob = glue.problem(b, S[0:3].T, S[3:6].T, rows)
        u0 = hover if b == 0 else ref.shift(blocks[b - 1]["thrusts"][rows])
        glue_gap = max(glue_gap, _max(blk["p0"][rows] - prob.p0),
                       _max(blk["v0"][rows] - prob.v0),
                       _max(blk["obstacles"][rows] - prob.obstacles),
                       _max(blk["mask"][rows].double() - prob.obstacle_mask.double()),
                       _max(blk["v_cap"][rows] - prob.v_cap),
                       _max(blk["u_init"][rows] - u0))
        sp = ref_loop.setpoints(T, dt, c.dt, blk["positions"][rows], blk["velocities"][rows],
                                blk["accelerations"][rows])
        for name, mine in zip(("spp", "spv", "spa"), sp):
            glue_gap = max(glue_gap, _max(blk[name][:, rows] - mine))
        s, cg, J = plan_consistency(c, prob, blk["thrusts"][rows], blk["positions"][rows],
                                    blk["velocities"][rows], blk["accelerations"][rows],
                                    blk["cost"][rows])
        plan_gap, plan_cost = max(plan_gap, s), max(plan_cost, cg)
        probs.append(prob)
        u_inits.append(u0)
        J_prog.append(J)

    stacked = ref.Problem(*[torch.cat([getattr(p, f) for p in probs]) for f in ref.Problem._fields])
    res = ref.solve(c, stacked, torch.cat(u_inits))
    J_ref = ref.cost(c, _f64(stacked), res.thrusts.double())
    del res

    S_out, acc = ref_loop.tick_block(
        ctrl, plant, dt, T, int(loop["physics_substeps"]),
        torch.cat([blk["S_in"][:, rows] for blk in blocks], dim=1),
        *[torch.cat([blk[n][:, rows] for blk in blocks], dim=1) for n in ("spp", "spv", "spa")],
        torch.cat([blocks[0]["gw"][:, rows]] * len(blocks), dim=1),
        torch.cat([blocks[0]["obs_rows"][:, rows]] * len(blocks), dim=1))
    prog_out = torch.cat([blk["S_out"][:, rows] for blk in blocks], dim=1)
    prog_acc = torch.cat([blk["acc"][:, rows] for blk in blocks], dim=1)
    continuous = list(range(0, 21)) + [25, 26, 27, 28, 29]
    per_block = torch.maximum((prog_out[continuous] - S_out[continuous]).abs().amax(0),
                              (prog_acc[:4] - acc[:4]).abs().amax(0))
    flips = float(((prog_out[21:25] - S_out[21:25]).abs() > 0.5).any(0).double().mean())

    metrics = torch.stack([blk["acc"][:4] for blk in blocks])
    final = blocks[-1]["S_out"][0:3].T
    want = ref_loop.outcome(loop, metrics, final, inp["goals"])
    outcome_gap = 0.0
    for name, v in want.items():
        got = result[name]
        if v.dtype == torch.bool:
            outcome_gap = max(outcome_gap, float((got != v).any()) * OUTCOME_FLIP)
        else:
            outcome_gap = max(outcome_gap, _max(got.double() - v.double()))
    tick_q = float(torch.quantile(per_block.double().cpu(), TICK_QUANTILE))
    out = {"glue_gap": glue_gap, "plan_gap": plan_gap, "plan_cost_gap": plan_cost,
           "tick_gap": max(tick_q, outcome_gap), "tick_gap_max": float(per_block.max()),
           "outcome_gap": outcome_gap, "tick_flip_share": flips}
    out.update(excess_stats("plan_excess", torch.cat(J_prog), J_ref))
    return out
