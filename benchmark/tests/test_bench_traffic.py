"""The traffic generator: the same seed gives the same inputs, other seeds
others, and the copies give what the originals they were taken from give
(``bench_torch.bench_problem``'s draws, ``scripts/diag_timeouts_torch``'s
``build_fleet``), at small sizes on the CPU."""

from __future__ import annotations

import json
import sys

import numpy as np
import pytest
import torch

from benchmark.lib import harness, traffic

SPHERES = harness.load_traffic("spheres")
PERCEIVED = harness.load_traffic("perceived")
MC = json.loads((harness.HERE / "configs/mc_fleet.json").read_text())


def small_mc(episodes=6, replans=3):
    return dict(MC, episodes=episodes, loop=dict(MC["loop"], num_replans=replans))


def draws(kind, seed):
    if kind == "spheres":
        return traffic.generate(SPHERES, {"scenarios": 32}, seed, "cpu")
    return traffic.generate(PERCEIVED, small_mc(), seed, "cpu")


@pytest.mark.parametrize("kind", ["spheres", "perceived"])
def test_a_seed_repeats_and_seeds_differ(kind):
    big = 2 ** 31 + 12345
    a, b, c = draws(kind, big), draws(kind, big), draws(kind, big + 1)
    assert a.keys() == b.keys() == c.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert any(not torch.equal(a[k], c[k]) for k in a if a[k].is_floating_point())


def test_sphere_fleet_is_the_bench_problem():
    sys.path.insert(0, str(harness.ROOT))
    import bench_torch
    from dart_planner_tpu_torch.planning import se3_mpc

    seed, B = 7, 16
    got = traffic.generate(SPHERES, {"scenarios": B}, seed, "cpu")
    cfg = se3_mpc.SE3MPCConfig()
    want = bench_torch.bench_problem(np.random.default_rng(seed), B, cfg, "cpu")
    mine = se3_mpc.make_problem(got["positions"][0], got["velocities"][0], got["goal"],
                                obstacles=got["obstacles"], config=cfg)
    for name in ("p0", "v0", "goal", "obstacles", "obstacle_mask"):
        assert torch.equal(getattr(mine, name), getattr(want, name)), name
    assert got["positions"].shape == (SPHERES["state_pool"], B, 3)
    assert torch.allclose(got["timestamps"][3], torch.full((B,), 0.3))


def test_perceived_fleet_is_build_fleet():
    sys.path.insert(0, str(harness.ROOT / "scripts"))
    import diag_timeouts_torch as dt
    from dart_planner_tpu_torch.sim import WorldConfig, closed_loop

    cfg = small_mc(episodes=5, replans=4)
    lp = cfg["loop"]
    loop = closed_loop.ClosedLoopConfig(**{k: v for k, v in lp.items()
                                          if k in closed_loop.ClosedLoopConfig._fields})
    want = dt.build_fleet(5, 11, "cpu", loop, max_replans=4, world_config=WorldConfig())
    got = traffic.generate(PERCEIVED, cfg, 11, "cpu")
    pairs = {"starts": want.states.position, "goals": want.goals,
             "true_obstacles": want.true_obstacles, "true_mask": want.true_mask,
             "obstacles": want.obstacles, "mask": want.mask, "corridor": want.corridor,
             "wind": want.wind, "noise": want.noise}
    for name, w in pairs.items():
        assert torch.equal(got[name], w), name
    assert got["mask"].any(), "the mapper perceives some sphere"
