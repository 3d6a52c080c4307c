"""The port's edge<->cloud deployment (``dart_planner_tpu_torch.apps``:
cloud, edge, minimal takeoff) on the CPU, against the JAX package.

Held against the JAX package on the same inputs:

- the cloud: ``update_state`` -> ``plan_once`` -> ``get_trajectory`` at
  ``SE3MPCConfig(max_iterations=4, gn_warmup_iterations=2,
  tail_iterations=0)`` from the same states (a cold plan, a warm-started
  one, then one beside the scene's spheres): the same L1 goal (float32,
  exactly), the same occupied-voxel count, the same obstacles extracted
  (1e-5 m); the trajectories served within 1e-3 m in position and
  1e-2 m/s in velocity where no obstacle reaches the planner, and beside
  the spheres, where a solve may branch at near-ties (ROADMAP C.9), both
  thrust plans costed on the port's problem within 1e-4 relative and the
  positions within 1e-2 m;
- the edge's exchange: a port cloud's ZMQ server answers a JAX edge and a
  port edge, which both reject an out-of-envelope plan and accept the same
  plan as the same arrays (exactly), after sending the same state;
- the edge's splice and ticks: the same plan applied to both edges at the
  JAX package's order of the smoother's limits
  (``interop.smoother_config_from_jax_fields``), 60 ticks at 200 Hz: the
  positions within 1e-4 m;
- the takeoff: the first 0.5 s of ``minimal_takeoff``'s flight (the JAX
  order), positions within 1e-4 m.

The loopback round trip (the cloud in a process of its own, over ZMQ) and
the failsafe run on the wall clock, so the round trip keeps the JAX test's
one retry. Every socket is on a port the OS assigns.
"""

import asyncio
import os
import socket
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import numpy as np
import torch

from dart_planner_tpu.apps import cloud as J_cloud
from dart_planner_tpu.apps import edge as J_edge
from dart_planner_tpu.common.types import Trajectory as JTrajectory
from dart_planner_tpu.comms import SecureSerializer as JSerializer
from dart_planner_tpu.hardware.simulated_vehicle import SimulatedVehicleIO as JVehicle
from dart_planner_tpu.planning.se3_mpc import SE3MPCConfig as JConfig
from dart_planner_tpu_torch import Trajectory, interop
from dart_planner_tpu_torch.apps.cloud import ThreeLayerCloudController
from dart_planner_tpu_torch.apps.edge import EdgeConfig, EdgeController, FailsafeTier
from dart_planner_tpu_torch.apps.minimal_takeoff import minimal_takeoff
from dart_planner_tpu_torch.comms import SecureSerializer, ZmqServer
from dart_planner_tpu_torch.hardware import VehicleIOFactory
from dart_planner_tpu_torch.planning import se3_mpc as T
from dart_planner_tpu_torch.planning.se3_mpc import SE3MPCConfig

ROOT = Path(__file__).resolve().parents[1]
KEY = "app-test-key"
SMALL = dict(max_iterations=4, gn_warmup_iterations=2, tail_iterations=0)
FIELDS = ("timestamps", "positions", "velocities", "accelerations")
# the cloud's states: a cold plan, a warm-started one, then one near the
# demo scene's spheres, whose voxels the mapper then hands the planner
STATES = [((0.2, -0.1, 2.0), (0.3, 0.0, 0.1)), ((0.2, -0.1, 2.0), (0.3, 0.0, 0.1)),
          ((8.0, 2.0, 4.0), (0.5, 0.2, 0.0))]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---- the cloud against the JAX package ----
def test_cloud_plans_match_jax():
    jc = J_cloud.ThreeLayerCloudController(
        port=_free_port(), mpc_config=JConfig(**SMALL), serializer=JSerializer(secret_key=KEY))
    tc = ThreeLayerCloudController(
        port=_free_port(), mpc_config=SE3MPCConfig(**SMALL),
        serializer=SecureSerializer(secret_key=KEY), device="cpu")
    try:
        for c in (jc, tc):
            c.initialize_demo_mission()
        np.testing.assert_array_equal(tc.scene_obstacles.numpy(), np.asarray(jc.scene_obstacles))
        assert tc.scene_obstacles.device == tc.se3_planner.device == tc.mapper.device
        ser = SecureSerializer(secret_key=KEY)
        for k, (pos, vel) in enumerate(STATES):  # cold, warm, then near the spheres
            state = {"timestamp": 1.0 + 0.1 * k, "position": np.float32(pos),
                     "velocity": np.float32(vel)}
            request = ser.serialize({"command": "update_state", "data": state})
            # signed bytes in: the JAX server's dispatch, the port's request handling
            assert jc.server._dispatch(request) == {"status": "ok", "result": {"ok": True}}
            assert ser.deserialize(tc.server.handle(request)) == {
                "status": "ok", "result": {"ok": True}}
            assert tc.last_state.position.device == tc.se3_planner.device
            jc.plan_once()
            tc.plan_once()
            np.testing.assert_array_equal(tc.se3_planner.goal_position,
                                          np.asarray(jc.se3_planner.goal_position))
            jm, tm = jc.mapper.get_mapping_stats(), tc.mapper.get_mapping_stats()
            assert tm["occupied_voxels"] == jm["occupied_voxels"] > 0
            assert tm["total_voxels"] == jm["total_voxels"]
            assert len(tc.se3_planner.obstacles) == len(jc.se3_planner.obstacles)
            for (tcen, tr), (jcen, jr) in zip(tc.se3_planner.obstacles, jc.se3_planner.obstacles):
                np.testing.assert_allclose(tcen, np.asarray(jcen), atol=1e-5)
                assert abs(tr - jr) <= 1e-5
            jt = jc._handle_get_trajectory(None)
            tt = tc._handle_get_trajectory(None)
            assert tt["available"] and jt["available"]
            for name in FIELDS:
                assert isinstance(tt[name], np.ndarray) and tt[name].dtype == np.float32
                assert tt[name].shape == np.asarray(jt[name]).shape
            np.testing.assert_allclose(tt["timestamps"], jt["timestamps"], atol=1e-6)
            if not tc.se3_planner.obstacles:  # convex: one Newton path
                np.testing.assert_allclose(tt["positions"], jt["positions"], atol=1e-3)
                np.testing.assert_allclose(tt["velocities"], jt["velocities"], atol=1e-2)
                continue
            # with obstacles the solve may branch at near-ties (ROADMAP C.9):
            # both thrust plans costed on the port's problem, and the plans
            planner = tc.se3_planner
            prob = planner._problem(tc.last_state)
            c_t = float(T._finalize(planner.config, prob, planner.last_solution).cost)
            u_j = torch.tensor(np.asarray(jc.se3_planner.last_solution, np.float32))
            c_j = float(T._finalize(planner.config, prob, u_j).cost)
            assert abs(c_t - c_j) <= 1e-4 * abs(c_j), (c_t, c_j)
            np.testing.assert_allclose(tt["positions"], jt["positions"], atol=1e-2)
        assert len(tc.se3_planner.obstacles) == 8  # the last state sees the spheres
        assert tc._handle_status(None)["plans"] == jc._handle_status(None)["plans"] == 3
    finally:
        jc.server.stop()
        tc.server.stop()


# ---- the edge's exchange across the packages ----
def _plan(n=20, v=1.0):
    ts = np.float32(0.1) * np.arange(n, dtype=np.float32)
    pos = np.stack([v * ts, 0 * ts, 2.0 + 0 * ts], -1).astype(np.float32)
    vel = np.tile(np.float32([v, 0, 0]), (n, 1))
    return {"available": True, "timestamps": ts, "positions": pos, "velocities": vel,
            "accelerations": np.zeros((n, 3), np.float32)}


def test_edges_reject_an_out_of_envelope_plan():
    """A port cloud's server (over ZMQ) answers a JAX edge and a port edge:
    both send the same state, reject a plan at 40 m/s, and accept a good
    one as the same float32 arrays."""
    port = _free_port()
    server = ZmqServer(port=port, serializer=SecureSerializer(secret_key=KEY))
    states, serving = [], {}
    server.add_handler("update_state", lambda d: states.append(d) or {"ok": True})
    server.add_handler("get_trajectory", lambda d: serving["plan"])
    server.start()
    cfg = dict(cloud_port=port)
    jedge = J_edge.EdgeController(J_edge.EdgeConfig(**cfg), serializer=JSerializer(secret_key=KEY))
    tedge = EdgeController(EdgeConfig(**cfg), serializer=SecureSerializer(secret_key=KEY),
                           device="cpu")
    try:
        serving["plan"] = _plan(v=40.0)
        for e in (jedge, tedge):
            assert e._exchange_with_cloud() is None
            assert e.rejected_trajectories == 1
        serving["plan"] = _plan()
        jt, tt = jedge._exchange_with_cloud(), tedge._exchange_with_cloud()
        for name in FIELDS:
            t = getattr(tt, name)
            assert t.device == tedge.vehicle.device and t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jt, name)))
        assert tedge.rejected_trajectories == jedge.rejected_trajectories == 1
        assert len(states) == 4
        for js, ts in ((states[0], states[1]), (states[2], states[3])):
            assert js["timestamp"] == ts["timestamp"]
            for k in ("position", "velocity"):
                assert ts[k].dtype == js[k].dtype == np.float32
                np.testing.assert_array_equal(ts[k], js[k])
        assert interop.edge_config_from_jax_fields(J_edge.EdgeConfig()) == EdgeConfig()
    finally:
        jedge.stop()
        tedge.stop()
        server.stop()


def test_edge_splices_and_ticks_like_jax():
    """The same plan applied to both edges mid-flight, then 60 ticks at
    200 Hz, the port's smoother in the JAX package's order."""
    jedge = J_edge.EdgeController(J_edge.EdgeConfig(cloud_port=_free_port()))
    tedge = EdgeController(EdgeConfig(cloud_port=_free_port()), device="cpu")
    try:
        tedge.vehicle.smoother_config = interop.smoother_config_from_jax_fields(
            jedge.vehicle.smoother_config)
        jedge.vehicle.rb = jedge.vehicle.rb._replace(position=np.float32([0.0, 0.0, 2.0]))
        tedge.vehicle.rb = tedge.vehicle.rb.replace(position=torch.tensor([0.0, 0.0, 2.0]))
        asyncio.run(jedge.vehicle.arm())
        asyncio.run(tedge.vehicle.arm())
        for e in (jedge, tedge):
            for _ in range(5):
                e.vehicle.step()
        plan = _plan()
        plan["timestamps"] = plan["timestamps"] + np.float32(0.02)
        plan["positions"][:, 2] += np.float32(0.5)
        jedge._apply_trajectory(JTrajectory(**{k: plan[k] for k in FIELDS}))
        tedge._apply_trajectory(Trajectory(**{k: torch.as_tensor(plan[k]) for k in FIELDS}))
        for _ in range(60):
            js, ts = jedge.vehicle.step(), tedge.vehicle.step()
        np.testing.assert_allclose(ts.position.numpy(), np.asarray(js.position), atol=1e-4)
        np.testing.assert_allclose(ts.velocity.numpy(), np.asarray(js.velocity), atol=1e-3)
        assert float(ts.position[2]) > 2.01  # the splice moved the vehicle
    finally:
        jedge.stop()
        tedge.stop()


def test_edge_failsafe_without_cloud():
    async def scenario():
        edge = EdgeController(
            EdgeConfig(cloud_port=_free_port(), control_frequency=100.0,  # nobody there
                       degraded_after_s=0.1, autonomous_after_s=0.3, emergency_after_s=1.2),
            device="cpu")
        stats = await edge.run(duration=3.0)
        edge.stop()
        return stats

    stats = asyncio.run(scenario())
    # without a cloud the tier decays to EMERGENCY and the loop stops early
    assert stats["tier"] == FailsafeTier.EMERGENCY.value
    assert stats["ticks"] > 0 and stats["final_position"].dtype == np.float32


# ---- minimal takeoff ----
def test_minimal_takeoff_flies():
    out = asyncio.run(minimal_takeoff(altitude=3.0, hover_s=1.0, device="cpu"))
    assert out["peak_altitude"] > 2.0
    assert out["final_altitude"] < 1.5  # came back down


def test_takeoff_matches_jax(monkeypatch):
    """minimal_takeoff's vehicle (``VehicleIOFactory``, the JAX package's
    smoother order) against the JAX vehicle: the first 0.5 s of the climb."""
    jv = JVehicle()
    tv = VehicleIOFactory.create("simulated", {"device": "cpu"})
    tv.smoother_config = interop.smoother_config_from_jax_fields(jv.smoother_config)

    async def climb(v):
        await v.connect()
        await v.arm()
        await v.takeoff(3.0)
        return v.run_for(0.5)

    js, ts = asyncio.run(climb(jv)), asyncio.run(climb(tv))
    np.testing.assert_allclose(ts.position.numpy(), np.asarray(js.position), atol=1e-4)
    assert float(ts.position[2]) > 0.02  # climbing


# ---- the round trip over tcp loopback ----
def _round_trip(port, client=None):
    """The edge flown against a cloud for 10 s of wall with the JAX test's
    generous tier windows: run statistics, plans received."""
    async def scenario():
        edge = EdgeController(
            EdgeConfig(cloud_port=port, control_frequency=50.0, degraded_after_s=2.0,
                       autonomous_after_s=30.0, emergency_after_s=120.0),
            serializer=SecureSerializer(secret_key=KEY), client=client, device="cpu")
        edge.vehicle.rb = edge.vehicle.rb.replace(position=torch.tensor([0.0, 0.0, 2.0]))
        edge.vehicle.step()
        applied = []
        apply = edge._apply_trajectory
        edge._apply_trajectory = lambda traj: applied.append(1) or apply(traj)
        stats = await edge.run(duration=10.0)
        edge.stop()
        return stats, len(applied), edge.rejected_trajectories

    stats, applied, rejected = asyncio.run(scenario())
    assert stats["tier"] in (FailsafeTier.NOMINAL.value, FailsafeTier.DEGRADED.value), stats
    assert stats["ticks"] > 100, stats
    assert applied > 0 and rejected == 0, (applied, rejected)
    # the vehicle climbed toward the takeoff-phase goal (z=5)
    assert float(stats["final_position"][2]) > 2.3, stats


CLOUD = (
    "import asyncio, sys\n"
    "from dart_planner_tpu_torch.apps.cloud import ThreeLayerCloudController\n"
    "from dart_planner_tpu_torch.planning.se3_mpc import SE3MPCConfig\n"
    "c = ThreeLayerCloudController(port=int(sys.argv[1]), device='cpu', mpc_config="
    "SE3MPCConfig(max_iterations=4, gn_warmup_iterations=2, tail_iterations=0))\n"
    "c.initialize_demo_mission()\n"
    "asyncio.run(c.run_planning_loop(60.0))\n"
)


def _zmq_round_trip():
    port = _free_port()
    env = {**os.environ, "DART_ZMQ_SECRET": KEY,
           "PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])}
    with tempfile.TemporaryFile() as log:
        proc = subprocess.Popen([sys.executable, "-c", CLOUD, str(port)], env=env,
                                stdout=log, stderr=subprocess.STDOUT)
        try:
            _round_trip(port)
            assert proc.poll() is None, "the cloud process died"
        except AssertionError as e:
            log.seek(0)
            raise AssertionError(f"{e}\ncloud output: {log.read()[-2000:]!r}") from e
        finally:
            proc.terminate()
            proc.wait(timeout=30)


def test_edge_cloud_round_trip_over_loopback():
    """The cloud in a process of its own (as deployed) at the small config,
    the edge in this one, over ZMQ on tcp loopback. Wall-clock coupled, so
    retried once as the JAX test is."""
    try:
        _zmq_round_trip()
    except AssertionError:
        _zmq_round_trip()


def test_edge_cloud_round_trip_in_process():
    """The smoke's transport where pyzmq is missing (``chip_smoke.py``'s
    ``in_process_pair``): the cloud plans on a thread of this process and
    the edge's requests reach its handlers as signed bytes, with no socket.
    Retried once, as the loopback round trip."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    def fly():
        server, client = chip_smoke.in_process_pair(KEY)
        cloud = ThreeLayerCloudController(mpc_config=SE3MPCConfig(**SMALL), server=server,
                                          device="cpu")
        cloud.initialize_demo_mission()
        thread = threading.Thread(target=asyncio.run, args=(cloud.run_planning_loop(60.0),))
        thread.start()
        try:
            _round_trip(0, client=client)
        finally:
            cloud.stop()
            thread.join(timeout=30)
        assert not thread.is_alive() and cloud.plan_count > 0

    try:
        fly()
    except AssertionError:
        fly()
