"""The port's compose file (deploy/docker-compose.torch.yml) beside the JAX
package's (deploy/docker-compose.yml): both parse, the port's ``app``
service runs the port's CLI on one reserved NVIDIA GPU and serves the
scrape target of deploy/prometheus.yml, and Prometheus and Grafana are the
same services on the same files. Then the command the file names runs here
on the CPU (``--device cpu --duration 2``, free ports, the file's
environment) in a subprocess under a 60 s timeout, and its ``/metrics``
answers once with status 200. No image is pulled."""

import os
import pathlib
import secrets
import shlex
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import yaml

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEPLOY = ROOT / "deploy"
PORT_CLI = "python -m dart_planner_tpu_torch.apps.cli run --mode=cloud"


def _compose(name: str) -> dict:
    return yaml.safe_load((DEPLOY / name).read_text())


def _environment(service: dict) -> dict:
    return dict(item.split("=", 1) for item in service["environment"])


def _scrape_target() -> tuple:
    prom = yaml.safe_load((DEPLOY / "prometheus.yml").read_text())
    job = next(j for j in prom["scrape_configs"] if j["metrics_path"] == "/metrics"
               and j["job_name"] != "prometheus")
    host, port = job["static_configs"][0]["targets"][0].split(":")
    return host, int(port)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_compose_files_parse_and_the_port_runs_its_cli_on_a_gpu():
    jax_file, port_file = _compose("docker-compose.yml"), _compose("docker-compose.torch.yml")
    jax_app, app = jax_file["services"]["app"], port_file["services"]["app"]
    assert "dart_planner_tpu.apps.cli run --mode=cloud" in jax_app["command"]
    assert app["command"].strip() == PORT_CLI
    devices = app["deploy"]["resources"]["reservations"]["devices"]
    assert any(d["driver"] == "nvidia" and d["capabilities"] == ["gpu"] and d["count"] == 1
               for d in devices)
    host, port = _scrape_target()
    assert host == "app"
    env = _environment(app)
    assert int(env["DART_METRICS_PORT"]) == port == int(_environment(jax_app)["DART_METRICS_PORT"])
    assert env["DART_METRICS_HOST"] == "0.0.0.0"
    assert f"{port}:{port}" in app["ports"]
    for name in ("prometheus", "grafana"):
        ours, theirs = port_file["services"][name], jax_file["services"][name]
        assert ours["volumes"] == theirs["volumes"] and ours["image"] == theirs["image"]
    assert "./prometheus.yml:/etc/prometheus/prometheus.yml:ro" in \
        port_file["services"]["prometheus"]["volumes"]
    assert "./grafana:/etc/grafana/provisioning" in port_file["services"]["grafana"]["volumes"]


def test_the_compose_command_serves_metrics_on_the_cpu(tmp_path):
    app = _compose("docker-compose.torch.yml")["services"]["app"]
    argv = shlex.split(app["command"])
    assert argv[0] == "python"
    metrics_port, zmq_port = _free_port(), _free_port()
    env = {**os.environ, **_environment(app), "DART_METRICS_PORT": str(metrics_port),
           "DART_ZMQ_SECRET": secrets.token_urlsafe(32)}
    log = tmp_path / "app.log"
    with log.open("w") as sink:
        proc = subprocess.Popen(
            [sys.executable, *argv[1:], "--device", "cpu", "--duration", "2", "--port",
             str(zmq_port)],
            cwd=ROOT, env=env, stdout=sink, stderr=subprocess.STDOUT,
        )
    status = None
    try:
        deadline = time.monotonic() + 60.0
        while status is None and proc.poll() is None and time.monotonic() < deadline:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{metrics_port}/metrics",
                                            timeout=5) as r:
                    r.read()
                    status = r.status
            except (urllib.error.URLError, ConnectionError):
                time.sleep(0.1)
        proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = log.read_text()
    assert status == 200, out[-2000:]
    assert proc.returncode == 0, out[-2000:]
