"""The port's scenario fleet (dart_planner_tpu_torch/parallel/scenario.py)
against the JAX package's ``solve_fleet`` on its 8-device CPU mesh, and
against itself across mesh sizes.

Tolerances: the single-phase core (``tail_iterations=0``) at N=8, 4 rounds
with obstacles: per-scenario costs 1e-5 relative (the solves may part by a
float32 ulp in a line-search near-tie, ROADMAP C.7/C.9, so costs and
aggregates are compared, not thrusts), FleetStats total and converged
exact, mean cost 1e-5, max gradient norm 1e-4. The port's own result is bit
for bit the same over 1, 2 and 4 CPU shards (one batch row's arithmetic
does not depend on the others').
"""

import jax
import numpy as np
import pytest
import torch

from dart_planner_tpu.parallel import scenario as JF
from dart_planner_tpu.planning import se3_mpc as JM
from dart_planner_tpu_torch.parallel import distributed, scenario
from dart_planner_tpu_torch.planning import se3_mpc as TM

JCFG = JM.SE3MPCConfig(prediction_horizon=8, max_iterations=4, tail_iterations=0)
CFG = TM.SE3MPCConfig(**JCFG._asdict())
CPU = torch.device("cpu")
SHARDS = [(1, 1), (2, 1), (4, 2)]  # (devices, hosts)


def _arrays(batch, seed=7):
    rng = np.random.default_rng(seed)
    obs = np.concatenate(
        [rng.normal(0, 4, (batch, 2, 3)), rng.uniform(0.4, 1.0, (batch, 2, 1))], axis=-1
    ).astype(np.float32)
    pos = rng.normal(0, 2, (batch, 3)).astype(np.float32) + np.float32([0, 0, 5])
    vel = rng.normal(0, 1, (batch, 3)).astype(np.float32)
    goal = rng.normal(0, 4, (batch, 3)).astype(np.float32) + np.float32([0, 0, 5])
    return pos, vel, goal, obs


def _problems(batch, config=CFG, seed=7):
    pos, vel, goal, obs = _arrays(batch, seed)
    jcfg = JM.SE3MPCConfig(**config._asdict())
    return (JM.make_problem(pos, vel, goal, obstacles=obs, config=jcfg),
            TM.make_problem(pos, vel, goal, obstacles=obs, config=config, device="cpu"))


def _mesh(n, hosts):
    return scenario.make_fleet_mesh([CPU] * n, hosts=hosts)


def test_mesh_shapes():
    mesh = _mesh(8, None)
    assert mesh.size == 8 and mesh.shape == {"hosts": 1, "devices": 8}
    mesh2 = _mesh(8, 2)
    assert mesh2.shape == {"hosts": 2, "devices": 4}
    assert mesh2.local_rows == (0, 1) and len(mesh2.local_devices) == 8
    assert distributed.global_fleet_mesh([CPU] * 2).shape == {"hosts": 1, "devices": 2}
    with pytest.raises(ValueError):
        _mesh(8, 3)
    with pytest.raises(ValueError):
        scenario.make_fleet_mesh([])


def test_mesh_needs_a_card_or_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        scenario.make_fleet_mesh()
    assert scenario.make_fleet_mesh([CPU]).size == 1


def test_batch_sharding_is_contiguous_in_mesh_order():
    mesh = _mesh(4, 2)
    parts = scenario.batch_sharding(mesh, 16)
    assert [(sl.start, sl.stop) for _, sl in parts] == [(0, 4), (4, 8), (8, 12), (12, 16)]
    with pytest.raises(ValueError, match="divisible"):
        scenario.batch_sharding(mesh, 18)
    # a process that owns one row keeps its own part only
    row1 = scenario.FleetMesh(mesh.devices, (1,))
    assert [(sl.start, sl.stop) for _, sl in scenario.batch_sharding(row1, 16)] == \
        [(8, 12), (12, 16)]


@pytest.mark.parametrize("n, hosts", SHARDS)
def test_fleet_matches_jax_fleet(n, hosts):
    batch = 16
    pj, pt = _problems(batch)
    jmesh = JF.make_fleet_mesh(jax.devices()[:8], hosts=2)
    jres, jst = JF.solve_fleet(JCFG, jmesh, JF.shard_scenarios(pj, jmesh))
    res, st = scenario.solve_fleet(CFG, _mesh(n, hosts), pt)
    out = res.gather()
    assert len(res.shards) == n and res.global_batch == batch
    np.testing.assert_allclose(out.cost.numpy(), np.asarray(jres.cost, np.float32), rtol=1e-5)
    assert int(st.total) == int(jst.total) == batch
    assert int(st.converged) == int(jst.converged)
    np.testing.assert_allclose(float(st.mean_cost), float(jst.mean_cost), rtol=1e-5)
    np.testing.assert_allclose(float(st.max_grad_norm), float(jst.max_grad_norm), rtol=1e-4)


@pytest.mark.parametrize("n, hosts", SHARDS[1:])
def test_fleet_is_bit_identical_across_shards(n, hosts):
    _, pt = _problems(16)
    ref, ref_st = scenario.solve_fleet(CFG, _mesh(1, 1), pt)
    res, st = scenario.solve_fleet(CFG, _mesh(n, hosts), pt)
    for name, a, b in zip(ref.shards[0]._fields, ref.gather(), res.gather()):
        assert torch.equal(a, b), name
    for name in ("total", "converged", "max_grad_norm"):
        assert float(getattr(st, name)) == float(getattr(ref_st, name)), name
    np.testing.assert_allclose(float(st.mean_cost), float(ref_st.mean_cost), rtol=1e-6)


def test_stats_equal_fleet_statistics():
    _, pt = _problems(16)
    res, st = scenario.solve_fleet(CFG, _mesh(4, 1), pt)
    host = scenario.fleet_statistics(res)
    assert host == scenario.fleet_statistics(res.gather())
    assert int(st.total) == host["total"] == 16
    assert int(st.converged) == host["converged"]
    np.testing.assert_allclose(float(st.mean_cost), host["mean_cost"], rtol=1e-6)
    assert float(st.max_grad_norm) == host["max_grad_norm"]


def test_fleet_composes_with_per_scenario_v_cap():
    """A fleet carrying per-scenario velocity caps shards them with the
    rest, and the 1.5 m/s cap binds against an uncapped solve."""
    cfg = CFG._replace(max_iterations=6)
    _, pt = _problems(32, cfg, seed=4)
    capped = pt._replace(v_cap=torch.full((32,), 1.5))
    mesh = _mesh(4, 2)
    res, _ = scenario.solve_fleet(cfg, mesh, capped)
    free, _ = scenario.solve_fleet(cfg, mesh, pt)
    assert all(s.v_cap.shape == (8,) for s in scenario.shard_scenarios(capped, mesh).shards)
    assert torch.isfinite(res.gather().cost).all()
    assert res.gather().velocities.abs().max() < free.gather().velocities.abs().max()


def test_without_stats_returns_none_and_reduces_nothing(monkeypatch):
    _, pt = _problems(8)

    def no_collective(*a, **k):
        raise AssertionError("with_stats=False reduced stats")

    monkeypatch.setattr(scenario, "_reduce_stats", no_collective)
    monkeypatch.setattr(torch.distributed, "all_reduce", no_collective)
    res, st = scenario.solve_fleet(CFG, _mesh(2, 1), pt, with_stats=False)
    assert st is None and res.gather().cost.shape == (8,)


def test_warm_start_and_two_phase_run_per_shard():
    """A Sharded warm start chains fleet calls; with the tail on, each
    shard refines its own worst quarter."""
    cfg = CFG._replace(tail_iterations=2)
    _, pt = _problems(16)
    mesh = _mesh(2, 1)
    sp = scenario.shard_scenarios(pt, mesh)
    res, st = scenario.solve_fleet(cfg, mesh, sp)
    again, _ = scenario.solve_fleet(cfg, mesh, sp, res.map(lambda r: r.thrusts))
    full_u, _ = scenario.solve_fleet(cfg, mesh, sp, res.gather().thrusts)
    assert int(st.total) == 16
    for a, b in zip(again.gather(), full_u.gather()):
        assert torch.equal(a, b)
    assert bool((again.gather().cost <= res.gather().cost * (1 + 1e-5)).all())


def test_host_local_problem_in_one_process():
    _, pt = _problems(8)
    mesh = _mesh(2, 1)
    sp = distributed.host_local_problem(pt, mesh)
    assert sp.global_batch == 8 and [s.p0.shape[0] for s in sp.shards] == [4, 4]
    for a, b in zip(sp.gather(), pt):
        assert (a is None and b is None) or torch.equal(a, b)
    with pytest.raises(ValueError, match="divisible"):
        distributed.host_local_problem(pt, _mesh(3, 1))
    t = distributed.measure_throughput(CFG, mesh, sp, reps=1, passes=1)
    assert t["global_batch"] == 8 and t["devices"] == 2 and t["processes"] == 1
    assert t["solves_per_s"] > 0
