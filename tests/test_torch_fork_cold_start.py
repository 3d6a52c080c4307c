"""The cold start after a fork (ROADMAP C.23), on the CPU, against numpy and
the JAX package.

A process that had started CUDA and then forked a
``runtime.multiprocess_loop.ProcessControlLoop`` hung in its next cold start
at a new horizon, in numpy's multithreaded OpenBLAS inverse of the 100 x 100
quadratic Hessian. The port now takes that inverse from a Cholesky factor by
torch's LAPACK. Here a fresh process warms numpy's thread pool, starts and
stops the loop, takes the cold start's inverse at N=100 from an empty cache
and plans once, under a 60 s timeout:

- the inverse equals ``np.linalg.inv`` of the same Hessian within 1e-6 of
  its largest entry, in float32 (bit for bit up to N=40; past it the two
  float64 routes part by ~1e-12 relative, and float32 rounding then flips
  the last bit of some entries);
- the plan's finalized cost equals the JAX package's plan from the same
  start within 1e-4 relative, the tolerance of
  tests/test_torch_config.py::test_config_planner_first_plan_matches_jax
  at N=100 without obstacles.

``scripts/fork_lapack_hang.py`` runs the same order with CUDA started, on the
card.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

from dart_planner_tpu.apps.web_demo import DEMO_SCENARIOS
from dart_planner_tpu.common.types import DroneState as JDroneState
from dart_planner_tpu.planning import se3_mpc as J
from dart_planner_tpu_torch import DroneState
from dart_planner_tpu_torch.ops import costs
from dart_planner_tpu_torch.planning import se3_mpc as T

N = 100
ROOT = pathlib.Path(__file__).resolve().parents[1]

_CHILD = """
import sys
import numpy as np
from dart_planner_tpu_torch import DroneState
from dart_planner_tpu_torch.planning import se3_mpc
from dart_planner_tpu_torch.runtime.multiprocess_loop import ProcessControlLoop


def speed(state):
    return float(np.linalg.norm(state["velocity"]))


out, N, start, goal = sys.argv[1], int(sys.argv[2]), eval(sys.argv[3]), eval(sys.argv[4])
np.linalg.inv(np.eye(N) + np.ones((N, N)))  # numpy's thread pool is up before the fork
loop = ProcessControlLoop(speed, frequency_hz=50.0)
loop.start()
loop.send_state({"velocity": np.ones(3)})
while loop.get_output(timeout=0.05) is None:
    pass
loop.stop()
assert loop.error is None and not loop.running
assert se3_mpc._quadratic_hessian_inverse.cache_info().currsize == 0
config = se3_mpc.SE3MPCConfig(prediction_horizon=N)
hinv = se3_mpc._quadratic_hessian_inverse(config)
planner = se3_mpc.SE3MPCPlanner(config, device="cpu")
planner.plan_trajectory(DroneState.create(position=start, device="cpu"), goal)
np.savez(out, hinv=hinv, u=planner.last_solution.numpy())
"""


def _cost(config, prob, u) -> float:
    """The float32 cost of thrusts ``u`` on ``prob``: the solve's own
    (``costs.condensed_cost`` under the solver's gravity)."""
    g = T._gravity(config, u.dtype, u.device)
    return float(costs.condensed_cost(u, prob, config.weights, config.dt, config.mass, g))


def test_cold_start_after_a_fork_matches_numpy_and_jax(tmp_path):
    sc = DEMO_SCENARIOS["obstacle_avoidance"]
    start, goal = tuple(sc["start_pos"]), tuple(sc["goal_pos"])
    out = tmp_path / "child.npz"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    subprocess.run([sys.executable, "-c", _CHILD, str(out), str(N), repr(start), repr(goal)],
                   check=True, timeout=60, env=env, cwd=ROOT)
    got = np.load(out)

    config = T.SE3MPCConfig(prediction_horizon=N)
    H = costs.quadratic_hessian(N, config.dt, config.mass, config.gravity, config.weights)
    ref = np.linalg.inv(np.asarray(H, np.float64)).astype(np.float32)
    assert got["hinv"].dtype == np.float32 and got["hinv"].shape == (N, N)
    assert np.abs(got["hinv"] - ref).max() <= 1e-6 * np.abs(ref).max()

    jp = J.SE3MPCPlanner(J.SE3MPCConfig(prediction_horizon=N))
    jp.plan_trajectory(JDroneState.create(position=start), np.float32(goal))
    tp = T.SE3MPCPlanner(config, device="cpu")
    tp.set_goal(goal)
    prob = tp._problem(DroneState.create(position=start, device="cpu"))
    c_t = _cost(config, prob, torch.tensor(got["u"]))
    c_j = _cost(config, prob, torch.tensor(np.asarray(jp.last_solution)))
    assert abs(c_t - c_j) <= 1e-4 * abs(c_j), (c_t, c_j)


def test_cold_start_inverse_calls_no_numpy_lapack(monkeypatch):
    """The repair itself, which the test above cannot see on a host where
    numpy's inverse does not hang: the cold start's inverse at N=100, from
    an empty cache, takes no numpy LAPACK route (``inv``, the one that hung,
    nor ``solve`` or ``cholesky``) and still gives the float32 inverse."""
    def refuse(*args, **kwargs):
        raise AssertionError("the cold start called numpy's LAPACK")

    for name in ("inv", "solve", "cholesky"):
        monkeypatch.setattr(np.linalg, name, refuse)
    T._quadratic_hessian_inverse.cache_clear()
    try:
        hinv = T._quadratic_hessian_inverse(T.SE3MPCConfig(prediction_horizon=N))
    finally:
        T._quadratic_hessian_inverse.cache_clear()
    assert hinv.dtype == np.float32 and hinv.shape == (N, N)
    assert np.isfinite(hinv).all()
