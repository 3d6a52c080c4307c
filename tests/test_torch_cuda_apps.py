"""The edge<->cloud deployment on the card (dart_planner_tpu_torch/apps/,
comms/).

On a CUDA device (tests marked ``cuda``):

- a tensor on the card goes on the wire as its host copy: the signed text
  and the telemetry bytes equal those of its CPU copy, exactly;
- the cloud on the card: a state sent from another thread is built on the
  planner's device, each plan is two launches of B1, and the plan is
  served as host float32 arrays equal to the planner's (exactly);
- the edge on the card, linked to that cloud by the smoke's in-process
  pair (``chip_smoke.in_process_pair``): a fetched plan becomes a
  ``Trajectory`` on the vehicle's device, bit for bit the one served, and
  the vehicle flies it (z rises over 200 ticks).

Nothing here imports JAX, so these tests run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_apps.py -m cuda
"""

import asyncio
import json
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from dart_planner_tpu_torch.apps.cloud import ThreeLayerCloudController
from dart_planner_tpu_torch.apps.edge import EdgeController
from dart_planner_tpu_torch.comms import CompressionType, TelemetryCompressor
from dart_planner_tpu_torch.comms import serializer as ser
from dart_planner_tpu_torch.comms.zmq_transport import RequestHandler
from dart_planner_tpu_torch.ops import cuda_mpc

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ("timestamps", "positions", "velocities", "accelerations")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the solve kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_tensor_goes_to_the_wire_as_its_host_copy(cuda_device):
    t = torch.arange(6, dtype=torch.float32, device=cuda_device).reshape(2, 3)
    assert json.dumps(ser._encode_numpy({"t": t})) == json.dumps(
        ser._encode_numpy({"t": t.cpu()}))
    tc = TelemetryCompressor()
    for mode in (CompressionType.BINARY, CompressionType.NONE):
        out = tc.decompress_telemetry(tc.compress_telemetry({"t": t}, mode))
        np.testing.assert_array_equal(np.asarray(out["t"], np.float32), t.cpu().numpy())


def _cloud(server=None):
    cloud = ThreeLayerCloudController(server=server or RequestHandler())
    cloud.initialize_demo_mission()
    return cloud


@pytest.mark.cuda
def test_cuda_cloud_plans_through_b1(cuda_device):
    cloud = _cloud()
    assert cloud.se3_planner.device == cloud.mapper.device == cuda_device
    # the state arrives on another thread, as on the server's
    worker = threading.Thread(target=cloud._handle_update_state, args=(
        {"timestamp": 1.0, "position": [0.2, -0.1, 2.0], "velocity": [0.3, 0.0, 0.1]},))
    worker.start()
    worker.join(timeout=30)
    assert cloud.last_state.position.device == cuda_device
    before = cuda_mpc.LAUNCHES
    for _ in range(3):
        cloud.plan_once()
    torch.cuda.synchronize()
    assert cuda_mpc.LAUNCHES - before == 2 * 3
    out = cloud._handle_get_trajectory(None)
    t = cloud.last_trajectory
    for name in FIELDS:
        assert isinstance(out[name], np.ndarray) and out[name].dtype == np.float32
        np.testing.assert_array_equal(out[name], getattr(t, name).cpu().numpy())


@pytest.mark.cuda
def test_cuda_edge_flies_the_cloud_plan(cuda_device):
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    server, client = chip_smoke.in_process_pair("cuda-test-key")
    cloud = _cloud(server)
    edge = EdgeController(client=client)
    assert edge.vehicle.device == cuda_device
    asyncio.run(edge.vehicle.arm())
    edge.vehicle.rb = edge.vehicle.rb.replace(
        position=torch.tensor([0.0, 0.0, 2.0], device=cuda_device))
    edge._exchange_with_cloud()  # the cloud learns the state
    cloud.plan_once()
    traj = edge._exchange_with_cloud()
    for name in FIELDS:
        x = getattr(traj, name)
        assert x.device == cuda_device and x.dtype == torch.float32
        assert torch.equal(x, getattr(cloud.last_trajectory, name))
    edge._apply_trajectory(traj)
    z0 = float(edge.vehicle.get_state().position[2])
    for _ in range(200):
        edge.vehicle.step()
    assert float(edge.vehicle.get_state().position[2]) > z0 + 0.05
    assert edge.rejected_trajectories == 0
