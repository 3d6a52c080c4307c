"""The port's solve examples (examples_torch/: intermediate/batched_solves.py,
advanced/fleet_sharding.py, advanced/three_layer_mission.py) on the CPU,
each held against the JAX package on the same numpy inputs. Each example
is loaded by path and called as ``main(device="cpu", <small sizes>)``; the
JAX side repeats its JAX example's calls at the same sizes.

Tolerances, from the parity tests that already cover each call:

- batched_solves at B=64, N=8 (tests/test_torch_se3_mpc.py): with the tail
  on, the aggregate contract of ``test_two_phase_solve_obstacles_aggregate``
  (mean costs within 5% both ways, converged shares within 0.15); with the
  tail off, costs at rtol 1e-5 scenario by scenario at the example's full
  budget, and thrusts at atol 2e-3 at one CG-2 Newton round, where the path
  cannot branch (ROADMAP C, reference fault 9: at the full budget the
  converged plateau is flat, and this batch's thrusts part by up to
  0.0515 N in 22 of 64 scenarios at costs within 2.1e-7);
- fleet_sharding on eight CPU devices, 8 scenarios a device
  (tests/test_torch_parallel.py's ``test_fleet_matches_jax_fleet``): at one
  CG-2 round, costs at rtol 1e-5 scenario by scenario and FleetStats total
  and converged exact; at the example's own budget (N=12, 8 rounds, the
  tail per shard), the fleet's mean cost at rtol 1e-5 and its total (the
  full budget parts near-ties: 6 of 64 scenario costs differ by more than
  1e-5, by up to 1.7e-3, with the mean cost 5.6e-6 apart);
- three_layer_mission at its own size (40 replans, N=12): the phases
  printed equal, and the position after every replan within 1e-3 m
  (tests/test_torch_three_layer.py holds one pass through the layers; 40
  replans through a perfect-tracking plant compound; the largest
  difference measured is 3.04e-4 m).
"""

import contextlib
import importlib.util
import io
import pathlib

import jax
import numpy as np

from dart_planner_tpu.common.types import DroneState as JDroneState
from dart_planner_tpu.parallel import scenario as JF
from dart_planner_tpu.perception import GeometricMapper as JMapper
from dart_planner_tpu.planning import global_mission as JG
from dart_planner_tpu.planning import se3_mpc as J
from dart_planner_tpu_torch.planning import se3_mpc as T
from _torch_one_thread import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _example(rel: str):
    """An examples_torch/ script loaded by path, as a module."""
    spec = importlib.util.spec_from_file_location(
        "examples_torch_" + rel.replace("/", "_"), ROOT / "examples_torch" / f"{rel}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(fn, *args, **kw):
    """``fn``'s result and what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def _np(x):
    return np.asarray(x, np.float32)


# ---- batched_solves -------------------------------------------------------

BATCH = 64
SOLVE_CFG = T.SE3MPCConfig(prediction_horizon=8)


def _batched_both(config):
    example = _example("intermediate/batched_solves")
    out, text = _run(example.main, batch=BATCH, config=config, device="cpu")
    position, velocity, goal, obstacles = example.scenario_arrays(BATCH)
    jcfg = J.SE3MPCConfig(**config._asdict())
    pj = J.make_problem(position, velocity, goal, obstacles=obstacles, config=jcfg)
    return out, text, J.solve(jcfg, pj, method="xla"), goal


def test_batched_solves_aggregate_matches_jax():
    out, text, rj, goal = _batched_both(SOLVE_CFG)
    rt = out["result"]
    cj, ct = _np(rj.cost), rt.cost.numpy()
    assert np.mean(ct) <= np.mean(cj) * 1.05 and np.mean(cj) <= np.mean(ct) * 1.05
    assert abs(out["converged"] - float(np.mean(np.asarray(rj.converged)))) <= 0.15
    assert out["batch"] == BATCH and out["card"] == "cpu, host clock"
    np.testing.assert_allclose(out["mean_cost"], float(np.mean(ct, dtype=np.float64)),
                               rtol=1e-6)
    miss = np.linalg.norm(rt.positions[:, -1].numpy() - goal, axis=-1).max()
    np.testing.assert_allclose(out["worst_miss_m"], miss, rtol=1e-6)
    lines = text.splitlines()
    assert lines[0].startswith(f"{BATCH} scenarios in ") and "solves/s (cpu, host clock)" in lines[0]
    assert lines[1].startswith("converged: ") and "mean cost: " in lines[1]
    assert lines[2].startswith("worst terminal miss: ")


def test_batched_solves_tail_off_matches_jax():
    cfg = SOLVE_CFG._replace(tail_iterations=0)
    out, _, rj, _ = _batched_both(cfg)
    rt = out["result"]
    np.testing.assert_allclose(rt.cost.numpy(), _np(rj.cost), rtol=1e-5)
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    one, _, rj1, _ = _batched_both(cfg._replace(max_iterations=1, cg_iterations=2))
    np.testing.assert_allclose(one["result"].thrusts.numpy(), _np(rj1.thrusts), atol=2e-3)
    np.testing.assert_allclose(one["result"].cost.numpy(), _np(rj1.cost), rtol=1e-5)


# ---- fleet_sharding ------------------------------------------------------

PER_DEVICE = 8


def _fleet_both(config=None):
    """The port's example on eight CPU devices and the JAX example's calls
    on the JAX package's eight-device CPU mesh, at PER_DEVICE a device."""
    out, text = _run(_example("advanced/fleet_sharding").main, per_device=PER_DEVICE,
                     config=config, device="cpu")
    jcfg = J.SE3MPCConfig(**(config or T.SE3MPCConfig(prediction_horizon=12,
                                                      max_iterations=8))._asdict())
    mesh = JF.make_fleet_mesh(jax.devices()[:8])
    B = PER_DEVICE * mesh.devices.size
    rng = np.random.default_rng(0)
    lift = np.float32([0, 0, 5])
    prob = J.make_problem(
        rng.normal(0, 2, (B, 3)).astype(np.float32) + lift,
        rng.normal(0, 1, (B, 3)).astype(np.float32),
        rng.normal(0, 5, (B, 3)).astype(np.float32) + lift,
        config=jcfg,
    )
    jres, jst = JF.solve_fleet(jcfg, mesh, JF.shard_scenarios(prob, mesh), use_obstacles=False)
    return out, text, jres, jst


def test_fleet_sharding_one_round_matches_jax():
    cfg = T.SE3MPCConfig(prediction_horizon=12, max_iterations=1, cg_iterations=2,
                         tail_iterations=0)
    out, _, jres, jst = _fleet_both(cfg)
    res = out["result"]
    assert len(res.shards) == 8 and res.global_batch == 8 * PER_DEVICE
    np.testing.assert_allclose(res.gather().cost.numpy(), _np(jres.cost), rtol=1e-5)
    assert out["total"] == int(jst.total) == 8 * PER_DEVICE
    assert out["converged"] == int(jst.converged)
    np.testing.assert_allclose(out["mean_cost"], float(jst.mean_cost), rtol=1e-5)


def test_fleet_sharding_at_its_budget_matches_jax():
    out, text, jres, jst = _fleet_both()
    assert out["total"] == int(jst.total) == 8 * PER_DEVICE
    np.testing.assert_allclose(out["mean_cost"], float(jst.mean_cost), rtol=1e-5)
    assert out["mesh"] == {"hosts": 1, "devices": 8}
    assert out["shard_shapes"] == [(PER_DEVICE, 12, 3)]
    assert {tuple(s.data.shape) for s in jres.thrusts.addressable_shards} == \
        {(PER_DEVICE, 12, 3)}
    lines = text.splitlines()
    assert lines[0] == "mesh: {'hosts': 1, 'devices': 8} (8 devices)"
    assert lines[1].startswith(f"fleet of {8 * PER_DEVICE}: ")
    assert lines[2] == f"per-device shard shapes: [{(PER_DEVICE, 12, 3)}]"


# ---- three_layer_mission ---------------------------------------------------

REPLANS = 40
# 40 replans through a perfect-tracking plant compound the plans' float32
# differences: the largest difference between the two packages' positions
# measured on the CPU is 3.04e-4 m (the first replan's 0)
THREE_LAYER_TOL_M = 1e-3


def _jax_three_layer(replans: int, horizon: int = 12):
    """The JAX example's calls (examples/advanced/three_layer_mission.py):
    the position after each replan and the phases it prints."""
    mission = JG.GlobalMissionPlanner()
    mission.set_mission_waypoints([
        JG.SemanticWaypoint((0.0, 0.0, 3.0), "takeoff_point"),
        JG.SemanticWaypoint((6.0, 2.0, 3.0), "survey_corner"),
        JG.SemanticWaypoint((10.0, -2.0, 4.0), "goal_pad"),
    ])
    mapper = JMapper(resolution=0.5)
    mapper.add_obstacle((5.0, 0.0, 3.0), 0.8)
    planner = J.SE3MPCPlanner(J.SE3MPCConfig(prediction_horizon=horizon))
    obstacles, mask = mapper.extract_obstacles(center=(5.0, 0.0, 3.0))
    for row, ok in zip(obstacles, mask):
        if ok:
            planner.add_obstacle(row[:3], float(row[3]))
    pos = np.float32([0.0, 0.0, 0.5])
    vel = np.zeros(3, np.float32)
    t = 0.0
    positions, phases = [], []
    for step in range(replans):
        state = JDroneState.create(timestamp=t, position=pos, velocity=vel)
        goal = mission.get_current_goal(state)
        traj = planner.plan_trajectory(state, goal)
        acc = np.asarray(traj.accelerations, np.float32)[1]
        vel = vel + acc * 0.1
        pos = pos + vel * 0.1
        t += 0.1
        positions.append(pos)
        if step % 10 == 0:
            phases.append(mission.current_phase.value)
    return np.stack(positions), phases


def test_three_layer_mission_matches_jax():
    out, text = _run(_example("advanced/three_layer_mission").main, device="cpu")
    jpos, jphases = _jax_three_layer(REPLANS)
    assert out["positions"].shape == (REPLANS, 3)
    assert out["phases"] == jphases == ["takeoff", "takeoff", "navigation", "navigation"]
    err = float(np.abs(out["positions"] - jpos).max())
    assert err <= THREE_LAYER_TOL_M, err
    assert out["stats"]["total_plans"] == REPLANS and out["stats"]["emergency_plans"] == 0
    lines = text.splitlines()
    assert len(lines) == REPLANS // 10 + 1
    for line, phase in zip(lines, jphases):
        assert f"phase={phase:<12} " in line
    assert lines[-1].startswith("mission stats: ")
