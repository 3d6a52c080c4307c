"""The port's multi-process fleet (dart_planner_tpu_torch/parallel/
distributed.py and worker.py) over real ``torch.distributed`` processes on
gloo, as tests/test_distributed.py runs the JAX package's over
``jax.distributed``.

Two worker processes with two CPU devices each (4 shards in all): the
stats all-reduced across the processes equal a single-process
recomputation of the same seeded fleet (total and converged exact, mean
cost 1e-6 relative: float64 sums over shards and processes, rounded to
float32, against a float64 mean; max gradient norm exact). Each process has a 120 s limit and leaves its
process group at the end.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from dart_planner_tpu_torch.parallel import distributed, scenario
from dart_planner_tpu_torch.parallel.worker import fleet_arrays
from dart_planner_tpu_torch.planning import se3_mpc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(num_processes, local_devices, batch, extra=(), timeout=120, backend="gloo"):
    """Run the worker ``num_processes`` times; return process 0's RESULT."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "dart_planner_tpu_torch.parallel.worker",
             "--coordinator", f"localhost:{port}",
             "--num-processes", str(num_processes), "--process-id", str(i),
             "--backend", backend, "--local-devices", str(local_devices),
             "--global-batch", str(batch), *extra],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT,
        )
        for i in range(num_processes)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-3000:]}"
    for line in outs[0].splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise AssertionError(f"no RESULT line from process 0:\n{outs[0][-3000:]}")


def test_two_process_fleet_stats_match_reference():
    r = _launch(2, 2, 32, extra=("--measure", "--reps", "2"))
    assert r["process_count"] == 2 and r["global_devices"] == 4
    s, ref = r["stats"], r["reference"]
    assert s["total"] == ref["total"] == 32.0
    assert s["converged"] == ref["converged"]
    np.testing.assert_allclose(s["mean_cost"], ref["mean_cost"], rtol=1e-6)
    assert s["max_grad_norm"] == ref["max_grad_norm"]
    t = r["throughput"]
    assert t["global_batch"] == 32 and t["processes"] == 2 and t["solves_per_s"] > 0


def test_world_of_one_reduces_like_no_group():
    """In one process: a gloo group of world size 1 (joined twice: the
    second call does nothing) gives the stats of no group at all."""
    cfg = se3_mpc.SE3MPCConfig(prediction_horizon=8, max_iterations=3, tail_iterations=0)
    f = fleet_arrays(8)
    prob = se3_mpc.make_problem(f["position"], f["velocity"], f["goal"],
                                obstacles=f["obstacles"], config=cfg, device="cpu")
    mesh = scenario.make_fleet_mesh([torch.device("cpu")] * 2)
    _, alone = scenario.solve_fleet(cfg, mesh, prob)
    port = _free_port()
    distributed.initialize(f"localhost:{port}", 1, 0, backend="gloo")
    try:
        distributed.initialize(f"localhost:{port}", 1, 0, backend="gloo")
        assert torch.distributed.get_world_size() == 1
        assert scenario.collective_device().type == "cpu"
        mesh = distributed.global_fleet_mesh([torch.device("cpu")] * 2)
        _, grouped = scenario.solve_fleet(cfg, mesh, prob)
    finally:
        distributed.shutdown()
    assert not torch.distributed.is_initialized()
    for a, b in zip(grouped, alone):
        assert float(a) == float(b)


def test_initialize_without_a_card_names_gloo(monkeypatch):
    """With no backend and no visible card, ``initialize`` raises and names
    ``backend="gloo"``: it never carries a group to the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='backend="gloo"'):
        distributed.initialize(f"localhost:{_free_port()}", 1, 0)
    assert not torch.distributed.is_initialized()
