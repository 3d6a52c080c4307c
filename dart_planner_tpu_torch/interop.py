"""Carry state across between the JAX package and this port.

The solver and the simulator have no weights: their "parameters" are the
configurations, the Problem arrays and the state of the vehicle-side
filters and the mission layer's grids. These helpers take numpy arrays,
dicts, dataclasses (a flax ``struct`` included) or any ``_asdict()``-able
object (a JAX ``NamedTuple`` included) and never import jax, so a test can
feed both packages the same inputs, the same warm-start thrust plan and
the same smoother, filter and grid state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dart_planner_tpu_torch.apps.edge import EdgeConfig
from dart_planner_tpu_torch.comms.telemetry import CompressionType, TelemetryPacket
from dart_planner_tpu_torch.control.geometric import GeometricConfig
from dart_planner_tpu_torch.control.smoother import SmootherConfig, SmootherState
from dart_planner_tpu_torch.estimation.ekf import EKFConfig, EKFState
from dart_planner_tpu_torch.hardware.mission import MissionConfig
from dart_planner_tpu_torch.neural_scene import PlaceholderNeuralScene, UncertaintyField
from dart_planner_tpu_torch.ops.costs import Problem
from dart_planner_tpu_torch.perception.mapper import MapperConfig
from dart_planner_tpu_torch.planning.global_mission import GlobalMissionConfig
from dart_planner_tpu_torch.planning.se3_mpc import SE3MPCConfig
from dart_planner_tpu_torch.security.validation import SafetyLimits
from dart_planner_tpu_torch.sim.closed_loop import ClosedLoopConfig
from dart_planner_tpu_torch.sim.physics import PhysicsConfig
from dart_planner_tpu_torch.sim.worlds import WorldConfig


def _fields(obj) -> dict:
    if isinstance(obj, dict):
        return dict(obj)
    if hasattr(obj, "_asdict"):
        return dict(obj._asdict())
    if dataclasses.is_dataclass(obj):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    raise TypeError(
        f"expected a dict, a dataclass or a NamedTuple, got {type(obj).__name__}"
    )


def config_from_jax_fields(d) -> SE3MPCConfig:
    """``SE3MPCConfig`` from a JAX config (or its ``_asdict()``)."""
    return SE3MPCConfig(**_fields(d))


def _nested(cls, d, nested: dict):
    """``cls`` from a JAX config, converting the nested configs named in
    ``nested`` (field -> the port's class) as well."""
    f = _fields(d)
    for name, sub in nested.items():
        if name in f:
            f[name] = sub(**_fields(f[name]))
    return cls(**f)


def closed_loop_config_from_jax_fields(d) -> ClosedLoopConfig:
    """``ClosedLoopConfig`` from a JAX one (or its ``_asdict()``), with its
    ``mpc``, ``physics`` and ``control`` configs carried across."""
    return _nested(
        ClosedLoopConfig, d,
        {"mpc": SE3MPCConfig, "physics": PhysicsConfig, "control": GeometricConfig},
    )


def world_config_from_jax_fields(d) -> WorldConfig:
    """``WorldConfig`` from a JAX one, with its ``mapper`` config."""
    return _nested(WorldConfig, d, {"mapper": MapperConfig})


def problem_from_numpy(prob, device="cpu") -> Problem:
    """Problem on ``device`` from numpy-convertible fields: floats become
    float32 tensors, the obstacle mask a bool tensor, a missing ``v_cap``
    stays None."""
    f = _fields(prob)
    out = {}
    for name in Problem._fields:
        x = f.get(name)
        if x is None:
            out[name] = None
            continue
        arr = np.array(x)  # a writable host copy
        dtype = torch.bool if name == "obstacle_mask" else torch.float32
        out[name] = torch.as_tensor(arr, device=device).to(dtype)
    return Problem(**out)


def result_to_numpy(res) -> dict:
    """Each field of a SolveResult (or any NamedTuple of tensors) as a numpy
    array on the host; None stays None."""
    return {
        k: None if v is None else v.detach().cpu().numpy()
        for k, v in _fields(res).items()
    }


def episode_result_to_numpy(res) -> dict:
    """Each field of an ``EpisodeResult`` as a numpy array on the host."""
    return result_to_numpy(res)


def smoother_config_from_jax_fields(d) -> SmootherConfig:
    """``SmootherConfig`` from a JAX one (or its ``_asdict()``), with the
    JAX package's order of rate limits and smoothing, so the port's
    smoother gives the JAX package's commands."""
    return SmootherConfig(**{"rate_limits": "before_smoothing", **_fields(d)})


def _tensors(cls, d, device):
    """``cls`` with each field of ``d`` as a tensor on ``device``: bools stay
    bool, other values become float32."""
    out = {}
    for name, x in _fields(d).items():
        arr = np.array(x)  # a writable host copy
        dtype = torch.bool if arr.dtype == np.bool_ else torch.float32
        out[name] = torch.as_tensor(arr, device=device).to(dtype)
    return cls(**out)


def smoother_state_from_numpy(state, device="cpu") -> SmootherState:
    """``SmootherState`` on ``device`` from the JAX package's state (its
    fields as numpy-convertible arrays), batch dims included."""
    return _tensors(SmootherState, state, device)


def ekf_config_from_jax_fields(d) -> EKFConfig:
    """``EKFConfig`` from a JAX one (or its ``_asdict()``)."""
    return EKFConfig(**_fields(d))


def ekf_state_from_numpy(state, device="cpu") -> EKFState:
    """``EKFState`` on ``device`` from the JAX package's (``x``, ``P``)."""
    return _tensors(EKFState, state, device)


def mission_config_from_jax_fields(d) -> MissionConfig:
    """The hardware runner's ``MissionConfig`` from the JAX package's (a
    dataclass) or a dict."""
    return MissionConfig(**_fields(d))


def global_mission_config_from_jax_fields(d) -> GlobalMissionConfig:
    """The L1 planner's ``GlobalMissionConfig`` from the JAX package's (a
    dataclass) or a dict."""
    return GlobalMissionConfig(**_fields(d))


def placeholder_scene_from_jax(scene, device="cpu") -> PlaceholderNeuralScene:
    """A ``PlaceholderNeuralScene`` on ``device`` holding the JAX scene's
    bounds, grids (density and uncertainty float32, semantics int32) and
    update count."""
    out = PlaceholderNeuralScene(scene.resolution, device=device)
    out.bounds = np.array(scene.bounds, np.float32)
    for name, dtype in (("density", torch.float32), ("uncertainty", torch.float32),
                        ("semantics", torch.int32)):
        grid = torch.as_tensor(np.array(getattr(scene, name)), device=device)
        setattr(out, name, grid.to(dtype))
    out.update_count = scene.update_count
    return out


def uncertainty_field_from_jax(field, device="cpu") -> UncertaintyField:
    """An ``UncertaintyField`` on ``device`` holding the JAX field's bounds,
    resolution, grid and update count."""
    out = UncertaintyField(np.array(field.bounds), field.resolution, device=device)
    out.grid = torch.as_tensor(np.array(field.grid, np.float32), device=device)
    out.update_count = field.update_count
    return out


def edge_config_from_jax_fields(d) -> EdgeConfig:
    """The edge's ``EdgeConfig`` from the JAX package's (a dataclass) or a
    dict, with its ``trajectory_limits`` carried across."""
    return _nested(EdgeConfig, d, {"trajectory_limits": SafetyLimits})


def telemetry_packet_from_jax(packet) -> TelemetryPacket:
    """A ``TelemetryPacket`` from the JAX package's (or a dict of its
    fields, the compression as its enum or its value): the same payload
    bytes, which the port's compressor decompresses."""
    f = _fields(packet)
    mode = f["compression"]
    return TelemetryPacket(**{**f, "compression": CompressionType(getattr(mode, "value", mode))})
