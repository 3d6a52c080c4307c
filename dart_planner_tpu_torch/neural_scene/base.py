"""Neural scene interface + placeholder (PyTorch counterpart of
:mod:`dart_planner_tpu.neural_scene.base`).

``BaseNeuralScene`` is the abstract interface (initialize / incremental
update / density / uncertainty / semantic queries / view rendering), and
``PlaceholderNeuralScene`` the voxel-grid stand-in. Real NeRF/3DGS
backends plug in behind the same interface; the placeholder stores dense
grids as tensors on one device (default: the card), so batched queries are
gathers there. Updates write the grids in place, where the JAX package
builds new arrays.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dart_planner_tpu_torch.common.device import resolve_device

Tensor = torch.Tensor


class BaseNeuralScene(abc.ABC):
    """(reference base_neural_scene.py:61-233)"""

    @abc.abstractmethod
    def initialize_scene(self, bounds: np.ndarray) -> None: ...

    @abc.abstractmethod
    def update_incremental(
        self, observations: Any, camera_poses: Optional[Any] = None
    ) -> None: ...

    @abc.abstractmethod
    def query_density(self, positions) -> Tensor: ...

    @abc.abstractmethod
    def query_uncertainty(self, positions) -> Tensor: ...

    @abc.abstractmethod
    def query_semantic_label(self, positions) -> Tensor: ...

    @abc.abstractmethod
    def render_view(self, camera_pose: Any, resolution: tuple) -> Tensor: ...

    @abc.abstractmethod
    def get_scene_statistics(self) -> Dict[str, Any]: ...


class PlaceholderNeuralScene(BaseNeuralScene):
    """Voxel-grid stand-in: density / uncertainty / semantic grids over a
    fixed extent; completely replaceable by a learned model."""

    def __init__(self, resolution: float = 0.5, device=None):
        self.resolution = resolution
        self.device = resolve_device(device)
        self.bounds: Optional[np.ndarray] = None
        self.density: Optional[Tensor] = None
        self.uncertainty: Optional[Tensor] = None
        self.semantics: Optional[Tensor] = None
        self.update_count = 0

    def initialize_scene(self, bounds: np.ndarray) -> None:
        """``bounds`` is (2, 3): [[min_xyz], [max_xyz]]."""
        self.bounds = np.asarray(bounds, np.float32)
        size = np.ceil((self.bounds[1] - self.bounds[0]) / self.resolution).astype(int)
        shape = tuple(int(s) for s in np.maximum(size, 1))
        kw = dict(device=self.device)
        self.density = torch.zeros(shape, dtype=torch.float32, **kw)
        self.uncertainty = torch.ones(shape, dtype=torch.float32, **kw)  # unknown = 1.0
        self.semantics = torch.zeros(shape, dtype=torch.int32, **kw)

    def _positions(self, positions) -> Tensor:
        return torch.as_tensor(positions, dtype=torch.float32, device=self.device)

    def _indices(self, positions: Tensor) -> tuple[Tensor, Tensor]:
        lo = torch.as_tensor(self.bounds[0], device=self.device)
        idx = torch.floor((positions - lo) / self.resolution).to(torch.int32)
        shape = torch.tensor(self.density.shape, dtype=torch.int32, device=self.device)
        inb = ((idx >= 0) & (idx < shape)).all(-1)
        idx = torch.minimum(torch.clamp(idx, min=0), shape - 1)
        return idx.long(), inb

    def _flat(self, idx: Tensor) -> Tensor:
        _, ny, nz = self.density.shape
        return (idx[..., 0] * ny + idx[..., 1]) * nz + idx[..., 2]

    def update_incremental(
        self, observations: Any, camera_poses: Optional[Any] = None
    ) -> None:
        """Accepts (positions (N,3), densities (N,)) pairs; writes the
        voxels (the max of each voxel's old and observed density) and halves
        their uncertainty once per observation, out-of-bounds points left
        out."""
        positions, densities = observations
        idx, inb = self._indices(self._positions(positions))
        d = torch.where(
            inb, torch.as_tensor(densities, dtype=torch.float32, device=self.device), 0.0
        )
        flat = self._flat(idx).reshape(-1)
        self.density.view(-1).scatter_reduce_(0, flat, d.reshape(-1), "amax")
        factor = torch.where(inb, 0.5, 1.0).reshape(-1)
        self.uncertainty.view(-1).scatter_reduce_(0, flat, factor, "prod")
        self.update_count += 1

    def _query(self, grid: Tensor, positions, outside) -> Tensor:
        idx, inb = self._indices(self._positions(positions))
        v = grid[idx[..., 0], idx[..., 1], idx[..., 2]]
        return torch.where(inb, v, torch.full_like(v, outside))

    def query_density(self, positions) -> Tensor:
        return self._query(self.density, positions, 0.0)

    def query_uncertainty(self, positions) -> Tensor:
        return self._query(self.uncertainty, positions, 1.0)

    def query_semantic_label(self, positions) -> Tensor:
        return self._query(self.semantics, positions, 0)

    def render_view(self, camera_pose: Any, resolution: tuple) -> Tensor:
        """Orthographic top-down density projection (placeholder render),
        resized by triangle-filter interpolation: bilinear with half-pixel
        centres, antialiased when it shrinks, as ``jax.image.resize``'s
        "linear"."""
        img = self.density.amax(dim=2)
        out = F.interpolate(
            img[None, None], size=tuple(resolution), mode="bilinear",
            align_corners=False, antialias=True,
        )
        return out[0, 0]

    def get_scene_statistics(self) -> Dict[str, Any]:
        return {
            "resolution": self.resolution,
            "voxels": int(np.prod(self.density.shape)) if self.density is not None else 0,
            "mean_uncertainty": self.uncertainty.mean().item()
            if self.uncertainty is not None
            else 1.0,
            "updates": self.update_count,
        }
