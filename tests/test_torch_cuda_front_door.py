"""The front door on the card: the DI container's planner and the web demo's
first plan through kernel B1, each against the plain path.

On a CUDA device (tests marked ``cuda``):

- the DI container's ``SE3MPCPlanner`` (the frozen config's solver, on the
  card by default) plans once from the demo's ``obstacle_avoidance``
  start with its spheres: two launches of B1, and its positions within
  1e-3 m of ``se3_mpc.solve(..., method="torch")`` on the same problem;
- ``DemoEngine`` on the card flies one replan of ``precision_landing``:
  its vehicle, planner and mapper on the card, two launches of B1, the
  frame's plan within 1e-3 m of the plain path's.

Nothing here imports JAX, so these tests run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_front_door.py -m cuda
"""

import asyncio
import json
import os

import numpy as np
import pytest
import torch

from dart_planner_tpu_torch import DroneState
from dart_planner_tpu_torch.apps.web_demo import DEMO_SCENARIOS, DemoEngine
from dart_planner_tpu_torch.common.di import create_default_container
from dart_planner_tpu_torch.config import reset_frozen_config
from dart_planner_tpu_torch.ops import cuda_mpc
from dart_planner_tpu_torch.planning import se3_mpc


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the solve kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture
def rec():
    """The first solve's (config, problem, warm start, obstacles flag,
    positions), recorded by ``chip_smoke.record_first_solve`` while the
    planner runs as it would."""
    import chip_smoke

    rec = []
    restore = chip_smoke.record_first_solve(rec)
    yield rec
    restore()


def _plain_gap(rec) -> float:
    import chip_smoke

    return chip_smoke.plain_gap(rec, "the first plan")


@pytest.mark.cuda
def test_cuda_di_planner_plans_through_b1(cuda_device, rec, monkeypatch):
    for k in [k for k in os.environ if k.startswith("DART_")]:
        monkeypatch.delenv(k)
    reset_frozen_config()
    sc = DEMO_SCENARIOS["obstacle_avoidance"]
    planner = create_default_container().resolve(se3_mpc.SE3MPCPlanner)
    assert planner.device == cuda_device
    assert planner.config == se3_mpc.SE3MPCConfig()
    for o in sc["obstacles"]:
        planner.add_obstacle(o["pos"], o["radius"])
    state = DroneState.create(position=sc["start_pos"], device=cuda_device)
    torch.cuda.synchronize()
    cuda_mpc.LAUNCHES = 0
    traj = planner.plan_trajectory(state, sc["goal_pos"])
    torch.cuda.synchronize()
    assert cuda_mpc.LAUNCHES == 2
    assert traj.positions.device == cuda_device and traj.positions.shape == (20, 3)
    assert _plain_gap(rec) <= 1e-3


class _Collect:
    def __init__(self, engine):
        self.engine, self.frames = engine, []

    async def send(self, payload):
        msg = json.loads(payload)
        self.frames.append(msg)
        if msg["type"] == "state_update":
            self.engine.is_running = False  # exactly one replan


@pytest.mark.cuda
def test_cuda_demo_engine_first_plan_through_b1(cuda_device, rec):
    engine = DemoEngine()
    assert engine.device == cuda_device

    async def main():
        client = _Collect(engine)
        engine.clients.add(client)
        assert engine.start("precision_landing")
        while not any(m["type"] == "mission_completed" for m in client.frames):
            await asyncio.sleep(0.01)
        await engine.stop()
        return client.frames

    torch.cuda.synchronize()
    cuda_mpc.LAUNCHES = 0
    frames = asyncio.run(main())
    torch.cuda.synchronize()
    assert cuda_mpc.LAUNCHES == 2
    assert engine.planner.device == engine.mapper.device == engine.vehicle.device == cuda_device
    (update,) = [m for m in frames if m["type"] == "state_update"]
    plan = np.float32(update["plan"])
    assert plan.shape == (20, 3) and np.isfinite(plan).all()
    np.testing.assert_array_equal(plan, rec[0][4].cpu().numpy())
    assert _plain_gap(rec) <= 1e-3
