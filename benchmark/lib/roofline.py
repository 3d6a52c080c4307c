"""The least time the card could take for the work of kernels B1 and B2,
reckoned from the configuration and the problem's shapes only, never from
a kernel's launch parameters or source: any implementation of the same
solve or tick block is held to the same work.

A frozen copy of ``bound_ms``, ``b1_bound`` and ``b2_bound`` of the
repository's ``chip_smoke.py`` with its H100 peaks, so that a later change
to the program does not move the yardstick. ``benchmark/tests`` holds the
copy to the original's numbers.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM peaks (data sheet, at a 700 W power limit): HBM3 bytes/s
# and fp32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# a precise sqrtf or division: one SFU op and its Newton refinement,
# counted as 8 fp32 operations
SQRT_DIV_OPS = 8
# fp32 operations per episode and control tick of the tick block (the
# controller, one substep of the plant, the metrics against 3 spheres)
B2_OPS_PER_TICK = 600


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the fp32 operations over the fp32 peak, and which it is."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def stage_counts(config) -> tuple[int, int]:
    """(Gauss-Newton rounds, full-curvature rounds) of one solve."""
    if not config.newton_full_curvature:
        return config.max_iterations, 0
    warmup = min(config.gn_warmup_iterations, config.max_iterations)
    return warmup, config.max_iterations - warmup


def constant_floats(config) -> int:
    """Floats of the solve's constant block: the step times and diag(H),
    each padded to whole lanes of 32 steps, then the line-search alphas."""
    return 2 * 32 * math.ceil(config.prediction_horizon / 32) + len(config.line_search_alphas)


def b1_work(config, B: int, live: float, slots: int, has_vcap: bool) -> tuple[float, float]:
    """(bytes, fp32 operations) of one projected-Newton solve of ``B``
    scenarios with ``live`` live spheres a scenario on average and
    ``slots`` padded sphere slots, per valid horizon step: one add per
    element for each prefix or suffix sum of a structured map (S_p is two
    sums, S_v one), an FMA as 2 operations, a precise sqrt or division as
    SQRT_DIV_OPS, the sphere terms only for live spheres. Every CG step of
    the budget is counted. Bytes: each input read once, each output written
    once, the constant block read once."""
    N = config.prediction_horizon
    K = float(live)
    q = SQRT_DIV_OPS
    n_gn, n_full = stage_counts(config)
    A = len(config.line_search_alphas)
    rollout = 24  # 2 prefix sums and the combine, 3 axes, plus C_pos, C_vel
    cost = 65 + K * (14 + q) + (9 + q) + (10 + q)  # quadratic, hinges, spheres
    cg_step = 168  # 2 prefix + 2 suffix sums, blocks, pull-back, dots, updates

    def round_ops(full: bool) -> float:
        spheres = K * (48 + 4 * q if full else 42 + 3 * q)
        tilt = 29 + 4 * q if full else 23 + 3 * q
        tnorm = 35 + 5 * q if full else 26 + 4 * q
        return (rollout + 46 + spheres + cost + 21 + 18 + tilt + tnorm + 18
                + (35 + 3 * q) + 15 + config.cg_iterations * cg_step
                + A * (36 + cost))

    ops = B * N * (n_gn * round_ops(False) + n_full * round_ops(True) + rollout + cost)
    floats_in = B * (N * 3 + 6 + N * 3 + slots * 5 + int(has_vcap))
    floats_out = B * (3 * N * 3 + 2)
    return 4 * (floats_in + floats_out + constant_floats(config)), ops


def b1_bound(config, prob) -> tuple[float, str]:
    """Bound of one solve of ``prob`` (anything with ``p0``, ``obstacles``,
    ``obstacle_mask`` and ``v_cap`` as the port's ``costs.Problem`` has
    them): :func:`b1_work` with the live spheres counted from the mask."""
    B = prob.p0.numel() // 3
    live = float(prob.obstacle_mask.sum()) / B
    n_bytes, ops = b1_work(config, B, live, prob.obstacles.shape[-2],
                           prob.v_cap is not None)
    return bound_ms(n_bytes, ops)


def tail_config(config):
    """The configuration of the two-phase solve's tail pass: full-curvature
    rounds at the tail's CG budget and line-search grid."""
    return config._replace(
        max_iterations=config.tail_iterations, cg_iterations=config.tail_cg_iterations,
        newton_full_curvature=True, gn_warmup_iterations=0, tail_iterations=0,
        restart_iterations=0, line_search_alphas=config.tail_line_search_alphas,
    )


def solve_bound_ms(config, B: int, live: float, slots: int, has_vcap: bool) -> float:
    """Bound of a whole solve: phase 1 over ``B`` scenarios and, with
    ``config.tail_iterations`` > 0, the tail over ``ceil(tail_capacity * B)``
    of them (the live spheres of the batch's average)."""
    total = bound_ms(*b1_work(config, B, live, slots, has_vcap))[0]
    if config.tail_iterations > 0:
        C = max(1, math.ceil(config.tail_capacity * B))
        total += bound_ms(*b1_work(tail_config(config), C, live, slots, has_vcap))[0]
    return total


def b2_bound(B: int, T: int, substeps: int, *tensors) -> tuple[float, str]:
    """Bound of one tick block: the bytes of its inputs and outputs, and
    B2_OPS_PER_TICK per episode, tick and substep."""
    n_bytes = sum(4 * t.numel() for t in tensors)
    return bound_ms(n_bytes, B * T * substeps * B2_OPS_PER_TICK)
