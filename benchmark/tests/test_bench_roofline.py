"""The benchmark's frozen copies of the bounds give ``chip_smoke.py``'s
numbers for the same shapes."""

from __future__ import annotations

import math
import sys

import pytest
import torch

from benchmark.lib import harness, roofline

sys.path.insert(0, str(harness.ROOT))


@pytest.mark.parametrize("B,K,live,vcap,cfg", [
    (4096, 8, 4, False, {}), (131072, 8, 4, False, {}), (16384, 11, 5, True,
                                                           {"tail_iterations": 0}),
    (64, 8, 0, False, {"prediction_horizon": 100}), (1, 8, 8, True, {"cg_iterations": 25}),
])
def test_b1_bound_is_chip_smokes(B, K, live, vcap, cfg):
    import chip_smoke
    from dart_planner_tpu_torch.ops.costs import Problem
    from dart_planner_tpu_torch.planning.se3_mpc import SE3MPCConfig

    config = SE3MPCConfig(**cfg)
    mask = torch.zeros((B, K), dtype=torch.bool)
    mask[:, :live] = True
    prob = Problem(p0=torch.zeros(B, 3), v0=torch.zeros(B, 3), goal=torch.zeros(B, 3),
                   obstacles=torch.zeros(B, K, 4), obstacle_mask=mask,
                   v_cap=torch.ones(B) if vcap else None)
    assert roofline.b1_bound(config, prob) == chip_smoke.b1_bound(config, prob)


def test_tail_bound_is_chip_smokes_tail_config():
    import chip_smoke
    from dart_planner_tpu_torch.ops.costs import Problem
    from dart_planner_tpu_torch.planning.se3_mpc import SE3MPCConfig

    config = SE3MPCConfig()
    B = 4096
    C = math.ceil(config.tail_capacity * B)
    mask = torch.zeros((C, 8), dtype=torch.bool)
    mask[:, :4] = True
    tail = Problem(p0=torch.zeros(C, 3), v0=torch.zeros(C, 3), goal=torch.zeros(C, 3),
                   obstacles=torch.zeros(C, 8, 4), obstacle_mask=mask)
    cfg_t = roofline.tail_config(config)
    whole = roofline.solve_bound_ms(config, B, 4, 8, False)
    p1 = roofline.b1_bound(config._replace(tail_iterations=0), _problem(B))[0]
    assert whole == pytest.approx(p1 + chip_smoke.b1_bound(cfg_t, tail)[0], rel=1e-12)


def _problem(B):
    from dart_planner_tpu_torch.ops.costs import Problem

    mask = torch.zeros((B, 8), dtype=torch.bool)
    mask[:, :4] = True
    return Problem(p0=torch.zeros(B, 3), v0=torch.zeros(B, 3), goal=torch.zeros(B, 3),
                   obstacles=torch.zeros(B, 8, 4), obstacle_mask=mask)


@pytest.mark.parametrize("B,T,substeps,K", [(2048, 40, 1, 3), (16384, 40, 1, 3),
                                             (64, 1000, 2, 0)])
def test_b2_bound_is_chip_smokes(B, T, substeps, K):
    import chip_smoke

    tensors = [torch.zeros(32, B), torch.zeros(3 * T, B), torch.zeros(3 * T, B),
               torch.zeros(3 * T, B), torch.zeros(8, B), torch.zeros(4 * K, B),
               torch.zeros(32, B), torch.zeros(8, B)]
    assert roofline.b2_bound(B, T, substeps, *tensors) == chip_smoke.b2_bound(
        B, T, substeps, *tensors)
    assert roofline.B2_OPS_PER_TICK == chip_smoke.B2_OPS_PER_TICK
    assert (roofline.HBM_BYTES_PER_S, roofline.FP32_OPS_PER_S) == (
        chip_smoke.HBM_BYTES_PER_S, chip_smoke.FP32_OPS_PER_S)
