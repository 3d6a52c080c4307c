"""Neural scene representation layer (PyTorch counterpart of
:mod:`dart_planner_tpu.neural_scene`): an abstract scene-model interface, a
voxel-grid placeholder, and an exploration uncertainty field. The grids are
tensors on one device; region extraction (a 1 Hz L1 operation) runs on the
host via scipy labelling."""

from dart_planner_tpu_torch.neural_scene.base import (
    BaseNeuralScene,
    PlaceholderNeuralScene,
)
from dart_planner_tpu_torch.neural_scene.uncertainty_field import (
    UncertaintyField,
    UncertaintyRegion,
)

__all__ = [
    "BaseNeuralScene",
    "PlaceholderNeuralScene",
    "UncertaintyField",
    "UncertaintyRegion",
]
