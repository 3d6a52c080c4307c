"""The port's entry points run on the card unless the caller asks for the
CPU: with no device given they resolve to ``cuda``, and without a card they
raise the error of ``common/device.py::default_device``, which names
``device="cpu"``. They never fall back to the CPU. Each test decides in its
body whether a card is visible."""

import numpy as np
import pytest
import torch

from dart_planner_tpu_torch import DroneState
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
from dart_planner_tpu_torch.runtime.fast_path import PlannerFastPath
from dart_planner_tpu_torch.sim import closed_loop, worlds

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
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    make = ENTRY_POINTS[name]
    if torch.cuda.is_available():
        assert make().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()


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
