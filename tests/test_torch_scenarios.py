"""The port's BASELINE scenario library and resumable sweep
(dart_planner_tpu_torch/sim/scenarios.py, sim/checkpoint.py) against the
JAX package's on the CPU.

Tolerances: hover-to-waypoint and mapper navigation positions 1e-3 m at
``FAST_MPC`` (single-phase solves of the same problems); figure-8 at
``FAST_MPC`` over 20 replans, both of the port's paths (the plain solve
with the per-tick loop, and the wrappers of kernels B1 and B2, which run
their plain versions on CPU tensors): per-replan positions 1e-3 m and the
tracking RMSE 1% relative. The sweep's random stream is the port's own
(ROADMAP C.5), so it is held to itself: a resumed sweep equals an
uninterrupted one bit for bit.
"""

import numpy as np
import pytest
import torch

from dart_planner_tpu.planning import se3_mpc as JM
from dart_planner_tpu.sim import scenarios as JS
from dart_planner_tpu.sim.checkpoint import load_checkpoint as jax_load
from dart_planner_tpu_torch.planning import se3_mpc as TM
from dart_planner_tpu_torch.sim import ClosedLoopConfig
from dart_planner_tpu_torch.sim import checkpoint, scenarios

JFAST = JM.SE3MPCConfig(prediction_horizon=10, max_iterations=6)
FAST = TM.SE3MPCConfig(**JFAST._asdict())


def test_hover_to_waypoint_matches_jax():
    ref = JS.hover_to_waypoint(config=JFAST)
    res = scenarios.hover_to_waypoint(config=FAST, device="cpu")
    np.testing.assert_allclose(res.positions.numpy(), np.asarray(ref.positions), atol=1e-3)
    np.testing.assert_allclose(res.thrusts.numpy(), np.asarray(ref.thrusts), atol=1e-2)


def test_hover_to_waypoint_reaches_the_goal_at_the_defaults():
    res = scenarios.hover_to_waypoint(device="cpu")
    assert np.linalg.norm(res.positions[-1].numpy() - [5, 0, 3]) < 0.5


def test_mapper_navigation_matches_jax():
    ref, jmapper = JS.mapper_navigation(config=JFAST)
    res, mapper = scenarios.mapper_navigation(config=FAST, device="cpu")
    pos = res.positions.numpy()
    np.testing.assert_allclose(pos, np.asarray(ref.positions), atol=1e-3)
    stats = mapper.get_mapping_stats()
    assert stats["occupied_voxels"] == jmapper.get_mapping_stats()["occupied_voxels"] > 0
    assert mapper.is_trajectory_safe(pos, safety_margin=0.2, threshold=0.8)


@pytest.mark.parametrize("method", ["torch", "fused"])
def test_figure8_matches_jax(method):
    R = 20
    ref = JS.figure8_tracking(mpc=JFAST, num_replans=R)
    res = scenarios.figure8_tracking(mpc=FAST, num_replans=R, device="cpu", method=method)
    assert res.positions.shape == (R, 3)
    np.testing.assert_allclose(res.references.numpy(), np.asarray(ref.references), atol=1e-5)
    np.testing.assert_allclose(res.positions.numpy(), np.asarray(ref.positions), atol=1e-3)
    np.testing.assert_allclose(float(res.tracking_rmse), float(ref.tracking_rmse), rtol=1e-2)
    np.testing.assert_allclose(float(res.max_error), float(ref.max_error), rtol=1e-2)


def test_checkpoint_keeps_the_jax_fields(tmp_path):
    """The port's .npz reads back through the JAX package's loader: the same
    field names and layout (only ``rng_key`` holds another generator's
    state)."""
    ck = checkpoint.FleetCheckpoint(
        rng_key=torch.Generator().manual_seed(3).get_state().numpy(),
        scenario_cursor=6, total_scenarios=10, successes=5, crashes=1,
        sum_final_distance=2.5, extras={"note": "x"},
    )
    path = tmp_path / "sweep.npz"
    checkpoint.save_checkpoint(path, ck)
    assert sorted(np.load(path).files) == ["extras", "rng_key", "scalars",
                                          "sum_final_distance"]
    for loaded in (checkpoint.load_checkpoint(path), jax_load(path)):
        assert (loaded.scenario_cursor, loaded.total_scenarios, loaded.successes,
                loaded.crashes) == (6, 10, 5, 1)
        assert loaded.sum_final_distance == 2.5 and loaded.extras == {"note": "x"}
        assert np.array_equal(loaded.rng_key, ck.rng_key)
    assert checkpoint.load_checkpoint(tmp_path / "none.npz") is None


def test_resumed_sweep_equals_an_uninterrupted_one(tmp_path):
    cfg = ClosedLoopConfig(mpc=FAST._replace(tail_iterations=0), num_replans=8,
                           wind_mean=1.0, wind_std=0.5, sensor_noise_std=0.02)
    kw = dict(total_scenarios=8, chunk=4, start_center=(0.0, 0.0, 3.0),
              goal_center=(3.0, 0.0, 4.0), device="cpu")
    whole = checkpoint.run_sweep(cfg, checkpoint_path=tmp_path / "a.npz", **kw)
    first = checkpoint.run_sweep(cfg, checkpoint_path=tmp_path / "b.npz", max_chunks=1, **kw)
    assert first.scenario_cursor == 4
    assert checkpoint.load_checkpoint(tmp_path / "b.npz").scenario_cursor == 4
    resumed = checkpoint.run_sweep(cfg, checkpoint_path=tmp_path / "b.npz", **kw)
    assert resumed.scenario_cursor == whole.scenario_cursor == 8
    assert (resumed.successes, resumed.crashes) == (whole.successes, whole.crashes)
    assert resumed.sum_final_distance == whole.sum_final_distance
    assert np.array_equal(resumed.rng_key, whole.rng_key)
    assert 0.0 <= resumed.success_rate <= 1.0
    # another seed draws another sweep
    other = checkpoint.run_sweep(cfg, checkpoint_path=tmp_path / "c.npz", seed=1, **kw)
    assert other.sum_final_distance != whole.sum_final_distance
