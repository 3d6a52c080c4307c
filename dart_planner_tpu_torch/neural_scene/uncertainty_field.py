"""Exploration uncertainty field (PyTorch counterpart of
:mod:`dart_planner_tpu.neural_scene.uncertainty_field`).

A dense grid of exploration uncertainty as a tensor on one device (default:
the card), per-position and regional updates (in place, where the JAX
package builds new arrays), connected high-uncertainty region extraction
and exploration target selection. Connected-component labelling (a 1 Hz
L1 operation) stays on the host with ``scipy.ndimage.label``, reached by an
explicit copy of the grid.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from dart_planner_tpu_torch.common.device import resolve_device

try:
    from scipy import ndimage

    _HAS_SCIPY = True
except ImportError:  # pragma: no cover
    _HAS_SCIPY = False


@dataclass
class UncertaintyRegion:
    """(reference uncertainty_field.py:373+)"""

    center: np.ndarray
    size_voxels: int
    mean_uncertainty: float


class UncertaintyField:
    """(reference uncertainty_field.py:33-306)"""

    def __init__(self, scene_bounds: np.ndarray, resolution: float = 1.0, device=None):
        self.bounds = np.asarray(scene_bounds, np.float32).reshape(2, 3)
        self.resolution = resolution
        self.device = resolve_device(device)
        size = np.maximum(
            np.ceil((self.bounds[1] - self.bounds[0]) / resolution).astype(int), 1
        )
        self.grid = torch.ones(
            tuple(int(s) for s in size), dtype=torch.float32, device=self.device
        )  # unknown = 1.0
        self.update_count = 0

    # -- index helpers (reference :291-306) --
    def _to_idx(self, position) -> np.ndarray:
        idx = np.floor(
            (np.asarray(position) - self.bounds[0]) / self.resolution
        ).astype(int)
        return np.clip(idx, 0, np.asarray(self.grid.shape) - 1)

    def _to_pos(self, idx) -> np.ndarray:
        return self.bounds[0] + (np.asarray(idx) + 0.5) * self.resolution

    def _host_grid(self) -> np.ndarray:
        return self.grid.cpu().numpy()

    # -- updates --
    def update_uncertainty_at_position(self, position, uncertainty: float) -> None:
        """(reference :66-88)"""
        i, j, k = self._to_idx(position)
        self.grid[i, j, k] = float(uncertainty)
        self.update_count += 1

    def reduce_uncertainty_around_position(
        self, position, radius: float, factor: float = 0.5
    ) -> None:
        """Observation visited a region (reference :221-260): scale down
        uncertainty within ``radius``, a mask over the voxel centres."""
        axes = [torch.arange(n, dtype=torch.float32, device=self.device)
                for n in self.grid.shape]
        ijk = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
        lo = torch.as_tensor(self.bounds[0], device=self.device)
        centers = (ijk + 0.5) * self.resolution + lo
        pos = torch.as_tensor(np.asarray(position, np.float32), device=self.device)
        d2 = ((centers - pos) ** 2).sum(-1)
        inside = d2 <= radius * radius
        self.grid = torch.where(inside, self.grid * factor, self.grid)
        self.update_count += 1

    # -- queries --
    def get_uncertainty_at_position(self, position) -> float:
        """(reference :110-125)"""
        i, j, k = self._to_idx(position)
        return self.grid[i, j, k].item()

    def identify_high_uncertainty_regions(
        self, threshold: float = 0.7, min_voxels: int = 2
    ) -> List[UncertaintyRegion]:
        """Connected components above threshold (reference :154-182 with
        flood fill :308-371), labelled on the host."""
        if not _HAS_SCIPY:
            raise RuntimeError("scipy required for region labeling")
        grid = self._host_grid()
        labels, n = ndimage.label(grid > threshold)
        regions = []
        for lab in range(1, n + 1):
            sel = labels == lab
            count = int(sel.sum())
            if count < min_voxels:
                continue
            idx = np.argwhere(sel)
            regions.append(
                UncertaintyRegion(
                    center=self._to_pos(idx.mean(axis=0)),
                    size_voxels=count,
                    mean_uncertainty=float(grid[sel].mean()),
                )
            )
        regions.sort(key=lambda r: -r.mean_uncertainty * r.size_voxels)
        return regions

    def get_exploration_targets(
        self, current_position, max_targets: int = 5, threshold: float = 0.7
    ) -> List[np.ndarray]:
        """Nearest-first high-uncertainty centers (reference :184-219)."""
        regions = self.identify_high_uncertainty_regions(threshold)
        cur = np.asarray(current_position, np.float32)
        regions.sort(key=lambda r: np.linalg.norm(r.center - cur))
        return [r.center for r in regions[:max_targets]]

    def get_statistics(self) -> Dict[str, float]:
        """(reference :262-289)"""
        g = self._host_grid()
        return {
            "mean_uncertainty": float(g.mean()),
            "max_uncertainty": float(g.max()),
            "explored_fraction": float((g < 0.5).mean()),
            "updates": self.update_count,
        }
