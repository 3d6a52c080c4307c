"""The hardware adapters on the card: the MAVLink mission and the secure
channel's upload, each plan through kernel B1.

On a CUDA device (tests marked ``cuda``), through ``chip_smoke.py``'s own
phases, which check as they go:

- ``chip_smoke.mavlink_phase`` (17a-b): ``start_mission`` over
  ``MavlinkVehicleIO`` on the card and a scripted link completes, every
  plan two launches of B1 and none of B2, more than 10 finite body-rate
  targets sent, the first plan within 1e-3 m of the plain path; then the
  link's heartbeats stop and the mission is grounded, 'heartbeat lost';
- ``chip_smoke.secure_phase`` (17c): ``SecureHardwareInterface`` over
  ``SimulatedVehicleIO`` on the card uploads a plan of two B1 launches,
  within 1e-3 m of the plain path; the vehicle closes on the goal, and the
  channel's gate refuses the viewer, the upload under an emergency stop
  and a disengage without the password.

Nothing here imports JAX, so these tests run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_adapters.py -m cuda
"""

import pytest
import torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the solve kernel has no CPU mode")
    from dart_planner_tpu_torch.ops import cuda_mpc

    cuda_mpc._library()  # built before a mission's clock starts
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_mavlink_mission_plans_through_b1(cuda_device):
    import chip_smoke

    out = chip_smoke.mavlink_phase(cuda_device, torch.cuda.get_device_name(0))
    assert out["plans"] > 0 and out["launches"] == 2 * out["plans"]
    assert out["per_plan"] == 2 and out["parity_m"] <= 1e-3


@pytest.mark.cuda
def test_secure_channel_uploads_a_b1_plan(cuda_device):
    import chip_smoke

    out = chip_smoke.secure_phase(cuda_device, torch.cuda.get_device_name(0))
    assert out["launches"] == 2 and out["parity_m"] <= 1e-3
    assert out["vehicle"].device == cuda_device
