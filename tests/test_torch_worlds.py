"""The port's mapper and worlds (dart_planner_tpu_torch/perception/ and
sim/worlds.py) against the JAX package on the same inputs.

Lidar hit distances agree to rtol 1e-5 (the ray directions come from sin
and cos of two libraries, ~1e-6 apart) with the same misses; grids updated
from the same rays agree to 1e-6; extracted obstacles have the same masks
and centers within 1e-5; coverage profiles agree to 1e-6 (a mean of 7
probes). JAX-sampled worlds are passed through to the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dart_planner_tpu.perception import mapper as JM
from dart_planner_tpu.sim import worlds as JW
from dart_planner_tpu_torch import interop
from dart_planner_tpu_torch.perception import mapper as TM
from dart_planner_tpu_torch.sim import worlds as TW

START = np.float32([0.0, 0.0, 3.0])
GOAL = np.float32([6.0, 3.0, 4.0])
WC = JW.WorldConfig(perceive_chunk=4)
TWC = interop.world_config_from_jax_fields(WC)
MC = WC.mapper


def _np(x):
    return np.asarray(x, np.float32)


def _jax_worlds(n, seed):
    return JW.sample_worlds(WC, jax.random.PRNGKey(seed), n, jnp.asarray(START),
                            jnp.asarray(GOAL))


def _scan(pos, spheres, mask):
    """One lidar scan in both packages from the same sensor and spheres."""
    j = JM.simulate_lidar_scan(MC, jnp.asarray(pos), jnp.asarray(spheres), jnp.asarray(mask))
    t = TM.simulate_lidar_scan(MC, torch.tensor(pos), torch.tensor(spheres),
                               torch.tensor(mask))
    return j, t


def test_config_defaults_match_jax():
    assert TW.WorldConfig()._asdict().keys() == JW.WorldConfig()._asdict().keys()
    assert TWC.mapper == TM.MapperConfig(**MC._asdict())
    assert TM.MapperConfig().ray_samples == JM.MapperConfig().ray_samples
    for n in (1, 7, 12, 24):
        np.testing.assert_array_equal(TM.unit_linspace(n).numpy(),
                                      _np(jnp.linspace(0.0, 1.0, n, dtype=jnp.float32)))


def test_lidar_scan_matches_jax():
    tobs, tmask = _jax_worlds(2, 1)
    spheres = _np(tobs[0])
    mask = np.asarray(tmask[0]).copy()
    mask[2] = False
    (jo, jd, jh), (to, td, th) = _scan(START, spheres, mask)
    jh, th = np.asarray(jh), th.numpy()
    hit = np.isfinite(jh)
    assert hit.any() and (~hit).any()
    np.testing.assert_array_equal(np.isfinite(th), hit)
    np.testing.assert_allclose(th[hit], jh[hit], rtol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=2e-6)
    np.testing.assert_array_equal(to.numpy(), np.broadcast_to(START, to.shape))


def test_update_with_scan_matches_jax():
    """Two scans from the same JAX rays: every voxel's log-odds within 1e-6,
    and the clip at the probability bounds."""
    tobs, tmask = _jax_worlds(1, 2)
    jm, tm = JM.create_map(MC), TM.create_map(MC)
    for pos in (START, np.float32([3.0, 1.5, 3.5])):
        jo, jd, jh = JM.simulate_lidar_scan(MC, jnp.asarray(pos), tobs[0], tmask[0])
        for _ in range(3):
            jm = JM.update_with_scan(MC, jm, jo, jd, jh)
            tm = TM.update_with_scan(MC, tm, *(torch.tensor(_np(x)) for x in (jo, jd, jh)))
    np.testing.assert_allclose(tm.log_odds.numpy(), _np(jm.log_odds), atol=1e-6)
    assert int(tm.total_observations) == int(jm.total_observations) == 6 * 360
    lo = tm.log_odds.numpy()
    assert (lo > 0).any() and (lo < 0).any()
    assert np.abs(lo).max() <= np.log(99.0) + 1e-6


def _mapped(seed=3):
    """A map holding one episode's scans, in both packages."""
    tobs, tmask = _jax_worlds(1, seed)
    jm, tm = JM.create_map(MC), TM.create_map(MC)
    for pos in (START, 0.5 * (START + GOAL), GOAL):
        jo, jd, jh = JM.simulate_lidar_scan(MC, jnp.asarray(pos), tobs[0], tmask[0])
        jm = JM.update_with_scan(MC, jm, jo, jd, jh)
        tm = TM.update_with_scan(MC, tm, *(torch.tensor(_np(x)) for x in (jo, jd, jh)))
    return jm, tm, tobs[0]


def test_queries_match_jax():
    jm, tm, spheres = _mapped()
    rng = np.random.default_rng(0)
    pts = _np(rng.uniform(-18, 18, (64, 3)) * [1, 1, 0.3] + [0, 0, 3])
    pts[:4] = _np(spheres[:, :3].tolist() + [[40.0, 0.0, 0.0]])  # inside, out of grid
    np.testing.assert_allclose(TM.query_occupancy(MC, tm, torch.tensor(pts)).numpy(),
                               _np(JM.query_occupancy(MC, jm, jnp.asarray(pts))), atol=1e-6)
    np.testing.assert_array_equal(TM.query_observed(MC, tm, torch.tensor(pts)).numpy(),
                                  np.asarray(JM.query_observed(MC, jm, jnp.asarray(pts))))
    cov_t = TM.corridor_observed_fraction(MC, tm, torch.tensor(START), torch.tensor(GOAL), 12)
    cov_j = JM.corridor_observed_fraction(MC, jm, jnp.asarray(START), jnp.asarray(GOAL), 12)
    np.testing.assert_allclose(cov_t.numpy(), _np(cov_j), atol=1e-6)
    traj = _np(np.linspace(START, GOAL, 10))[None].repeat(3, 0)
    traj[1, :, 2] += 5.0
    np.testing.assert_array_equal(
        TM.is_trajectory_safe(MC, tm, torch.tensor(traj)).numpy(),
        np.asarray(JM.is_trajectory_safe(MC, jm, jnp.asarray(traj))),
    )
    for center in (START, np.float32([-15.0, 15.0, 10.0])):  # clamps at the border
        occ_t, corner_t = TM.local_occupancy_grid(MC, tm, torch.tensor(center), 16)
        occ_j, corner_j = JM.local_occupancy_grid(MC, jm, jnp.asarray(center), 16)
        np.testing.assert_allclose(occ_t.numpy(), _np(occ_j), atol=1e-6)
        np.testing.assert_array_equal(corner_t.numpy(), _np(corner_j))


@pytest.mark.parametrize("ranking", ["nearest", "suppressed_segment"])
def test_extract_obstacles_matches_jax(ranking):
    jm, tm, _ = _mapped(4)
    mid = 0.5 * (START + GOAL)
    kw = {}
    if ranking == "suppressed_segment":
        kw = dict(suppression_radius=1.0)
        jkw = dict(kw, toward=jnp.asarray(GOAL), seg_start=jnp.asarray(START))
        tkw = dict(kw, toward=torch.tensor(GOAL), seg_start=torch.tensor(START))
    else:
        jkw = tkw = {}
    oj, mj = JM.extract_obstacles(MC, jm, jnp.asarray(mid), 8, **jkw)
    ot, mt = TM.extract_obstacles(MC, tm, torch.tensor(mid), 8, **tkw)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert mt.any()
    np.testing.assert_allclose(ot.numpy(), _np(oj), atol=1e-5)


def test_perceive_worlds_matches_jax_on_jax_worlds():
    n = 8
    tobs, tmask = _jax_worlds(n, 2)
    pj, mj, cj = JW.perceive_worlds(WC, tobs, tmask, jnp.asarray(START), jnp.asarray(GOAL),
                                    max_obstacles=8, corridor_samples=12)
    pt, mt, ct = TW.perceive_worlds(TWC, torch.tensor(_np(tobs)), torch.tensor(np.asarray(tmask)),
                                    torch.tensor(START), torch.tensor(GOAL),
                                    max_obstacles=8, corridor_samples=12)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert int(mt.sum()) > 0
    np.testing.assert_allclose(pt.numpy(), _np(pj), atol=1e-5)
    np.testing.assert_allclose(ct.numpy(), _np(cj), atol=1e-6)
    # the chunked batch equals one episode at a time
    one = TW._perceive_one(TWC, torch.tensor(_np(tobs[3])), torch.tensor(np.asarray(tmask[3])),
                           torch.tensor(START), torch.tensor(GOAL), 8)
    np.testing.assert_array_equal(one[0].numpy(), pt[3].numpy())


def test_worlds_from_draws_matches_jax_sample_worlds():
    """JAX's own draws (worlds.py:89-115) placed by the port give JAX's
    spheres."""
    n, K = 16, WC.num_obstacles
    key = jax.random.PRNGKey(9)
    starts = jnp.asarray(np.random.default_rng(1).normal(0, 2, (n, 3)) + [0, 0, 3], jnp.float32)
    goals = jnp.asarray(np.random.default_rng(2).normal(0, 2, (n, 3)) + [6, 3, 4], jnp.float32)
    jobs, _ = JW.sample_worlds(WC, key, n, starts, goals)
    k_t, k_lat, k_z, k_r, k_side = jax.random.split(key, 5)
    f32 = jnp.float32
    draws = [
        jax.random.uniform(k_t, (n, K, 1), f32, 0.25, 0.75),
        WC.lateral_jitter * jax.random.normal(k_lat, (n, K, 1), f32),
        WC.z_jitter * jax.random.normal(k_z, (n, K, 1), f32),
        jax.random.uniform(k_r, (n, K, 1), f32, WC.radius_min, WC.radius_max),
        jax.random.normal(k_side, (n, K, 1), f32),
    ]
    tobs, tmask = TW.worlds_from_draws(TWC, torch.tensor(_np(starts)), torch.tensor(_np(goals)),
                                       *(torch.tensor(_np(d)) for d in draws))
    assert tmask.all() and tmask.shape == (n, K)
    np.testing.assert_allclose(tobs.numpy(), _np(jobs), atol=1e-5)


def test_sample_worlds_geometry():
    """tests/test_worlds.py:32-45 on the port's own draws. The keepout push
    is lateral, so the gap bound holds for typical draws, not for every one
    (seed 1 of this generator leaves a gap of 0.977 m); the placement
    itself is held to JAX's by test_worlds_from_draws_matches_jax."""
    wc = TW.WorldConfig()
    obs, mask = TW.sample_worlds(wc, torch.Generator().manual_seed(0), 64,
                                 torch.tensor(START), torch.tensor(GOAL))
    assert obs.shape == (64, wc.num_obstacles, 4) and bool(mask.all())
    obs = obs.numpy()
    r = obs[..., 3]
    assert (r >= wc.radius_min - 1e-6).all() and (r <= wc.radius_max + 1e-6).all()
    for anchor in (START, GOAL):
        gap = np.linalg.norm(obs[..., :3] - anchor, axis=-1) - r
        assert (gap > wc.keepout - wc.radius_max - 1e-5).all()
    assert (obs[..., 2] >= 0.5 - 1e-6).all()


def test_monte_carlo_with_worlds_speed_cap():
    from dart_planner_tpu.planning import se3_mpc as JS
    from dart_planner_tpu.sim import ClosedLoopConfig

    fast = interop.closed_loop_config_from_jax_fields(ClosedLoopConfig(
        mpc=JS.SE3MPCConfig(prediction_horizon=8, max_iterations=4, cg_iterations=8),
        substeps_per_plan=20, num_replans=12, unknown_speed_cap=2.0,
    ))
    wc = TW.WorldConfig(perceive_chunk=4, corridor_samples=12)
    res, (tobs, tmask), (pobs, pmask) = TW.monte_carlo_with_worlds(
        fast, wc, torch.Generator().manual_seed(5), 4, torch.tensor(START),
        torch.tensor(GOAL), method="auto",
    )
    assert tobs.shape == (4, 3, 4) and pobs.shape == (4, 8, 4) and pmask.shape == (4, 8)
    assert np.isfinite(res.final_distance.numpy()).all()
    assert res.tracking_rmse.numpy().max() < 1.0


def test_mapper_facade():
    gm = TM.GeometricMapper(config=MC)
    gm.add_obstacle((2.0, 0.0, 3.0), 0.6)
    assert gm.is_collision((2.0, 0.0, 3.0)) and not gm.is_collision((-5.0, 0.0, 3.0))
    assert not gm.is_trajectory_safe([[0.0, 0.0, 3.0], [2.0, 0.0, 3.0]])
    o, d, h = gm.simulate_lidar_scan((0.0, 0.0, 3.0), [[3.0, 0.0, 3.0, 0.5]])
    gm.update_map(o, d, h)
    obs, mask = gm.extract_obstacles((1.0, 0.0, 3.0), 4)
    assert obs.shape == (4, 4) and mask.any()
    occ, corner = gm.get_local_occupancy_grid((0.0, 0.0, 3.0), 8)
    assert occ.shape == (8, 8, 8) and corner.shape == (3,)
    stats = gm.get_mapping_stats()
    assert stats["total_observations"] == 360 and stats["occupied_voxels"] > 0
    jm = JM.GeometricMapper(config=MC)
    jm.add_obstacle((2.0, 0.0, 3.0), 0.6)
    jm.update_map(*(np.asarray(x) for x in (o, d, h)))
    np.testing.assert_allclose(gm.map.log_odds.numpy(), _np(jm.map.log_odds), atol=1e-6)
    assert stats == {**jm.get_mapping_stats(), "total_queries": stats["total_queries"]}
