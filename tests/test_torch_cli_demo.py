"""The port's front door on the CPU: the CLI (``apps/cli.py``) and the web
demo (``apps/web_demo.py``), against the JAX package's.

- tests/test_apps.py's ``test_cli_parses`` and
  ``test_cli_serves_metrics_endpoint`` run against the port's CLI with
  ``--device cpu``; ``bench`` dispatches to the root ``bench_torch.py``;
  ``run --mode=sim --device cpu`` flies the minimal takeoff; without
  ``--device`` the CLI raises on a machine with no card.
- The 4 cases of tests/test_web_demo_e2e.py run against the port's
  ``web_demo.main`` on the CPU (the REST server, the websocket stream, the
  metrics endpoint). The flight builds its planner from a small config with
  the demo's N=20, ``SE3MPCConfig(max_iterations=4, gn_warmup_iterations=2,
  tail_iterations=0)``, patched in for ``web_demo.SE3MPCConfig`` while that
  test runs.
- One ``DemoEngine`` replan against the JAX package's on the same scenario
  at the demo's ``SE3MPCConfig()``: ``precision_landing`` (no obstacles)
  gives the same plan within 1e-3 m; ``obstacle_avoidance`` extracts the
  same spheres through the mapper (1e-5 m) and, where a solve may branch at
  line-search near-ties (ROADMAP C.9), both thrust plans costed on the
  port's problem agree within 1e-4 relative.

Every socket is on a port the OS assigns.
"""

import asyncio
import json
import pathlib
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from dart_planner_tpu.apps import web_demo as J_demo
from dart_planner_tpu_torch import DroneState
from dart_planner_tpu_torch.apps import cli, web_demo
from dart_planner_tpu_torch.common import metrics as metrics_mod
from dart_planner_tpu_torch.planning import se3_mpc as T

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = T.SE3MPCConfig(max_iterations=4, gn_warmup_iterations=2, tail_iterations=0)


def _cost(config, prob, u) -> float:
    """The float32 cost of thrusts ``u`` on ``prob``: the solve's own
    (``costs.condensed_cost`` under the solver's gravity)."""
    g = T._gravity(config, u.dtype, u.device)
    return float(T.costs.condensed_cost(u, prob, config.weights, config.dt, config.mass, g))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---- the CLI (tests/test_apps.py) ----
def test_cli_parses(monkeypatch):
    import runpy
    import sys

    with pytest.raises(SystemExit):
        cli.main([])  # no command
    with pytest.raises(SystemExit):
        cli.main(["run"])  # missing --mode
    # bench runs the root bench_torch.py as __main__ with its own arguments
    calls = []
    monkeypatch.setattr(runpy, "run_path",
                        lambda path, run_name: calls.append((path, run_name, list(sys.argv))))
    argv = list(sys.argv)
    assert cli.main(["bench", "--device", "cpu", "--seed", "3", "--budget-s", "90"]) == 0
    bench = str(ROOT / "bench_torch.py")
    assert calls == [(bench, "__main__",
                      [bench, "--device", "cpu", "--seed", "3", "--budget-s", "90.0"])]
    assert sys.argv == argv


def test_cli_serves_metrics_endpoint(monkeypatch):
    """DART_METRICS_PORT exposes the Prometheus exposition for any CLI
    mode (the deploy/ stack's scrape target)."""
    port = _free_port()
    monkeypatch.setenv("DART_METRICS_PORT", str(port))
    captured = {}
    orig = metrics_mod.MetricsManager.serve

    def spy(self, p, host="127.0.0.1"):
        srv = orig(self, p, host)
        captured["server"] = srv
        # probe while alive (cli shuts it down before returning)
        with urllib.request.urlopen(f"http://127.0.0.1:{p}/metrics", timeout=5) as r:
            captured["status"] = r.status
            captured["body"] = r.read().decode()
        return srv

    monkeypatch.setattr(metrics_mod.MetricsManager, "serve", spy)
    metrics_mod.get_metrics().increment("cli_test_marker")
    rc = cli.main(["run", "--mode=edge", "--duration", "1", "--device", "cpu"])
    assert rc == 0
    assert captured["status"] == 200
    assert "dart_cli_test_marker_total" in captured["body"]


def test_cli_needs_a_card_or_device_cpu(monkeypatch):
    """The CLI loads the frozen config first, then resolves its device:
    without a card and without ``--device cpu`` it raises and starts
    nothing; it never falls back to the CPU."""
    from dart_planner_tpu_torch.config import frozen_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["run", "--mode=cloud", "--port", str(_free_port())], ["demo"]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main(argv)
    monkeypatch.setenv("DART_PREDICTION_HORIZON", "1")  # an invalid config
    frozen_config.reset_frozen_config()
    try:
        with pytest.raises(frozen_config.ConfigurationError):
            cli.main(["run", "--mode=sim", "--device", "cpu"])
    finally:
        frozen_config.reset_frozen_config()


def test_cli_runs_the_takeoff_on_the_cpu(capsys):
    assert cli.main(["run", "--mode=sim", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "takeoff demo: peak" in out
    final = float(out.split("landed at")[1].split("m")[0])
    assert final < 1.5


# ---- the web demo end to end (tests/test_web_demo_e2e.py) ----
def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(port, path):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def demo_server():
    # find a port pair (REST on p, WebSocket on p+1)
    for _ in range(20):
        port = _free_port()
        with socket.socket() as s:
            if s.connect_ex(("127.0.0.1", port + 1)) != 0:
                break
    metrics_port = _free_port()
    loop = asyncio.new_event_loop()
    main = loop.create_task(web_demo.main(port=port, metrics_port=metrics_port, device="cpu"))

    def serve():
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(main)
        except asyncio.CancelledError:
            pass
        finally:
            rest = asyncio.all_tasks(loop)
            for task in rest:
                task.cancel()
            loop.run_until_complete(asyncio.gather(*rest, return_exceptions=True))
            loop.close()

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    deadline = time.time() + 30
    up = False
    while time.time() < deadline and not up:
        try:
            status, body = _get(port, "/api/health")
            up = status == 200 and body["status"] == "healthy"
        except OSError:
            time.sleep(0.2)
    try:
        assert up, "web demo server did not come up"
        yield port, metrics_port
    finally:
        loop.call_soon_threadsafe(main.cancel)
        thread.join(timeout=30)
        assert not thread.is_alive()


def test_scenario_catalogue_and_page(demo_server):
    port, _ = demo_server
    status, scenarios = _get(port, "/api/scenarios")
    assert status == 200
    assert set(scenarios) == {
        "obstacle_avoidance", "precision_landing", "edge_autonomy", "multi_waypoint"}
    assert scenarios == json.loads(json.dumps(J_demo.DEMO_SCENARIOS))
    for sc in scenarios.values():
        assert {"name", "description", "start_pos", "goal_pos"} <= set(sc)
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=10) as r:
        page = r.read().decode()
    assert "WebSocket" in page and "api/scenarios" in page


def test_error_surface(demo_server):
    port, _ = demo_server
    status, body = _post(port, "/api/start/not_a_scenario")
    assert status == 404 and "unknown" in body["error"]
    status, _ = _get(port, "/api/nope")
    assert status == 404


def test_full_demo_flight(demo_server, monkeypatch):
    """Start a real scenario, watch live frames stream over the WebSocket
    while the planner actually solves, then stop."""
    from websockets.sync.client import connect

    monkeypatch.setattr(web_demo, "SE3MPCConfig", lambda: SMALL)

    port, _ = demo_server
    with connect(f"ws://127.0.0.1:{port + 1}", open_timeout=15) as ws:
        status, body = _post(port, "/api/start/precision_landing")
        assert status == 200 and "started" in body["message"]

        # double-start must be rejected while running
        status, body = _post(port, "/api/start/edge_autonomy")
        assert status == 409

        status, st = _get(port, "/api/status")
        assert st["is_running"] and st["current_scenario"] == "precision_landing"
        assert st["connected_clients"] == 1

        frames = []
        deadline = time.time() + 120
        while len(frames) < 3 and time.time() < deadline:
            msg = json.loads(ws.recv(timeout=90))
            if msg["type"] == "state_update":
                frames.append(msg)
        assert len(frames) >= 3, "no live state frames received"

        f = frames[-1]
        # message-shape parity (the JAX demo's state_update)
        assert {"drone_state", "plan", "trajectory", "performance",
                "scenario", "goal", "status"} <= set(f)
        assert f["scenario"] == "precision_landing"
        assert len(f["plan"]) == 20  # N=20 horizon from the real solver
        perf = f["performance"]
        assert perf["planning_time_ms"] > 0.0
        assert perf["success_rate"] > 0.0
        assert perf["mapping_queries_per_sec"] > 0.0
        # the vehicle is descending toward the pad (start z=20, goal 0.5)
        z0 = frames[0]["drone_state"]["position"][2]
        z1 = frames[-1]["drone_state"]["position"][2]
        assert z1 <= z0 + 0.5

        status, _ = _post(port, "/api/stop")
        assert status == 200

    deadline = time.time() + 10
    while time.time() < deadline:
        _, st = _get(port, "/api/status")
        if not st["is_running"]:
            break
        time.sleep(0.2)
    assert not st["is_running"]


def test_metrics_endpoint_serves_flight_metrics(demo_server):
    """After a flight, /metrics carries measured planner quantiles and the
    replan counter in Prometheus text-exposition format."""
    port, metrics_port = demo_server
    with urllib.request.urlopen(f"http://127.0.0.1:{metrics_port}/metrics", timeout=10) as r:
        assert r.status == 200
        assert "text/plain" in r.headers["Content-Type"]
        body = r.read().decode()
    # recorded by the flight loop in test_full_demo_flight
    assert "dart_replans_total" in body
    assert 'dart_planning_time_ms{quantile="95"}' in body
    assert "dart_tracking_error_m" in body


# ---- one replan against the JAX package ----
class _Collect:
    """A websocket client stand-in: stops its engine after the first
    ``state_update`` frame, so the engine plans exactly once."""

    def __init__(self, engine):
        self.engine, self.frames = engine, []

    async def send(self, payload):
        msg = json.loads(payload)
        self.frames.append(msg)
        if msg["type"] == "state_update":
            self.engine.is_running = False


def _one_replan(engine, name: str) -> dict:
    async def main():
        client = _Collect(engine)
        engine.clients.add(client)
        assert engine.start(name)
        while not any(m["type"] == "mission_completed" for m in client.frames):
            await asyncio.sleep(0.01)
        await engine.stop()
        return client.frames

    frames = asyncio.run(main())
    updates = [m for m in frames if m["type"] == "state_update"]
    assert len(updates) == 1 and frames[-1]["type"] == "mission_completed"
    return updates[0]


@pytest.mark.parametrize("name", ["precision_landing", "obstacle_avoidance"])
def test_demo_engine_replan_matches_jax(name):
    te = web_demo.DemoEngine(device="cpu")
    je = J_demo.DemoEngine()
    tf, jf = _one_replan(te, name), _one_replan(je, name)
    assert set(tf) == set(jf)
    assert te.planner.device == te.mapper.device == te.vehicle.device == torch.device("cpu")
    assert te.planner.config == T.SE3MPCConfig()
    t_plan, j_plan = np.float32(tf["plan"]), np.float32(jf["plan"])
    assert t_plan.shape == j_plan.shape == (20, 3)
    assert len(te.planner.obstacles) == len(je.planner.obstacles)
    for (tc, tr), (jc, jr) in zip(te.planner.obstacles, je.planner.obstacles):
        np.testing.assert_allclose(tc, np.asarray(jc), atol=1e-5)
        assert abs(tr - jr) <= 1e-5
    if not te.planner.obstacles:  # convex: one Newton path
        np.testing.assert_allclose(t_plan, j_plan, atol=1e-3)
        return
    start = DroneState.create(position=web_demo.DEMO_SCENARIOS[name]["start_pos"], device="cpu")
    prob = te.planner._problem(start)
    u_j = torch.tensor(np.asarray(je.planner.last_solution, np.float32))
    c_t = _cost(te.planner.config, prob, te.planner.last_solution)
    c_j = _cost(te.planner.config, prob, u_j)
    assert abs(c_t - c_j) <= 1e-4 * abs(c_j), (c_t, c_j)
