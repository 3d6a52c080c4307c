"""The port's entry points run on the card unless the caller asks for the
CPU: with no device given they resolve to ``cuda``, and without a card they
raise the error of ``common/device.py::default_device``, which names
``device="cpu"``. They never fall back to the CPU. Each test decides in its
body whether a card is visible."""

import socket
from unittest.mock import MagicMock

import numpy as np
import pytest
import torch

from dart_planner_tpu_torch import DroneState
from dart_planner_tpu_torch.apps.autonomous import OnboardAutonomousController
from dart_planner_tpu_torch.apps.cloud import ThreeLayerCloudController
from dart_planner_tpu_torch.apps.edge import EdgeConfig, EdgeController
from dart_planner_tpu_torch.apps.web_demo import DemoEngine
from dart_planner_tpu_torch.common.di import create_default_container
from dart_planner_tpu_torch.hardware import (
    AirSimDroneInterface,
    AirSimVehicleIO,
    SafetyManager,
    VehicleIOFactory,
)
from dart_planner_tpu_torch.hardware.mavlink_adapter import MavlinkVehicleIO
from dart_planner_tpu_torch.common import device as D
from dart_planner_tpu_torch.common import frames
from dart_planner_tpu_torch.control.geometric import (
    ControllerState,
    ControlSetpoint,
    GeometricConfig,
    GeometricController,
)
from dart_planner_tpu_torch.perception.mapper import GeometricMapper
from dart_planner_tpu_torch.planning import PlannerFactory
from dart_planner_tpu_torch.planning import se3_mpc
from dart_planner_tpu_torch.parallel import distributed, scenario
from dart_planner_tpu_torch.planning.reference_mode import solve_reference_mode
from dart_planner_tpu_torch.runtime.fast_path import PlannerFastPath
from dart_planner_tpu_torch.sim import closed_loop, scenarios, worlds

SMALL = se3_mpc.SE3MPCConfig(prediction_horizon=8, max_iterations=2)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cloud_device():
    """The cloud controller's device, on a free port; its socket closed."""
    cloud = ThreeLayerCloudController(port=_free_port())
    cloud.server.stop()
    return cloud.se3_planner.device


def _edge_device():
    """The edge controller's device; its client closed."""
    edge = EdgeController(EdgeConfig(cloud_port=_free_port()))
    edge.stop()
    return edge.vehicle.device

ENTRY_POINTS = {
    "SE3MPCPlanner": lambda: se3_mpc.SE3MPCPlanner().device,
    "PlannerFastPath": lambda: PlannerFastPath().device,
    "GeometricController": lambda: GeometricController().device,
    "GeometricMapper": lambda: GeometricMapper().device,
    "PlannerFactory.create": lambda: PlannerFactory.create("se3_mpc").device,
    "make_problem": lambda: se3_mpc.make_problem(
        np.zeros((2, 3), np.float32), np.zeros((2, 3), np.float32),
        np.ones((2, 3), np.float32),
    ).p0.device,
    "sample_fleet": lambda: closed_loop.sample_fleet(
        torch.Generator().manual_seed(0), 2, (0.0, 0.0, 3.0), (4.0, 0.0, 3.0)
    )[1].position.device,
    "sample_worlds": lambda: worlds.sample_worlds(
        worlds.WorldConfig(), torch.Generator().manual_seed(0), 2,
        ((0.0, 0.0, 3.0),), ((4.0, 0.0, 3.0),),
    )[0].device,
    "DroneState.create": lambda: DroneState.create().position.device,
    "gravity_vector": lambda: frames.gravity_vector().device,
    "ControllerState.zeros": lambda: ControllerState.zeros(GeometricConfig()).last_time.device,
    "ControlSetpoint.hover_at": lambda: ControlSetpoint.hover_at((0.0, 0.0, 1.0)).position.device,
    "up_vector": lambda: frames.up_vector().device,
    "CoordinateFrameManager": lambda: frames.CoordinateFrameManager().get_up_vector().device,
    "solve_reference_mode": lambda: solve_reference_mode(
        SMALL, None, None, (1.0, 2.0, 3.0)).positions.device,
    "make_fleet_mesh": lambda: scenario.make_fleet_mesh().local_devices[0],
    "global_fleet_mesh": lambda: distributed.global_fleet_mesh().local_devices[0],
    "hover_to_waypoint": lambda: scenarios.hover_to_waypoint(SMALL).positions.device,
    "mapper_navigation": lambda: scenarios.mapper_navigation(SMALL)[0].positions.device,
    "figure8_tracking": lambda: scenarios.figure8_tracking(
        SMALL, num_replans=2).positions.device,
    "ThreeLayerCloudController": _cloud_device,
    "EdgeController": _edge_device,
    "OnboardAutonomousController": lambda: OnboardAutonomousController().device,
    # the vehicle minimal_takeoff flies (apps/minimal_takeoff.py)
    "minimal_takeoff vehicle": lambda: VehicleIOFactory.create(
        "simulated", {"device": None}).device,
    # the front door: the DI container's planner, the web demo
    "DI container SE3MPCPlanner": lambda: create_default_container().resolve(
        se3_mpc.SE3MPCPlanner).device,
    "DemoEngine": lambda: DemoEngine().device,
    # the hardware adapters (their clients injected)
    "MavlinkVehicleIO": lambda: MavlinkVehicleIO(mavutil=MagicMock()).device,
    "AirSimVehicleIO": lambda: AirSimVehicleIO(client=MagicMock()).device,
    "AirSimDroneInterface": lambda: AirSimDroneInterface(client=MagicMock()).device,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    make = ENTRY_POINTS[name]
    if torch.cuda.is_available():
        assert make().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()


def test_front_door_on_the_cpu_on_request():
    """The DI container's planner and the demo engine run on the CPU when
    given ``device="cpu"``."""
    cpu = torch.device("cpu")
    assert create_default_container(device="cpu").resolve(se3_mpc.SE3MPCPlanner).device == cpu
    assert DemoEngine(device="cpu").device == cpu


def test_safety_manager_checks_a_state_where_it_lies(monkeypatch):
    """The safety manager makes no tensors of its own: it reduces a state on
    the state's device, so a CPU state is checked without a card and
    without a copy to one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sm = SafetyManager()
    assert sm.check_state(DroneState.create(position=(0.0, 0.0, 5.0), device="cpu")) is None
    high = DroneState.create(position=(0.0, 0.0, 60.0), device="cpu")
    assert "altitude" in sm.check_state(high)


def test_cpu_on_request_and_factory_passes_device():
    planner = PlannerFactory.create("se3_mpc", device="cpu")
    assert isinstance(planner, se3_mpc.SE3MPCPlanner)
    assert planner.device == torch.device("cpu")
    small = PlannerFactory.create("se3_mpc", {"prediction_horizon": 8}, device="cpu")
    assert small.config.prediction_horizon == 8 and small.device.type == "cpu"
    assert D.resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            D.default_device()
