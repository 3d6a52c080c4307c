"""Carry state across between the JAX package and this port.

The solver and the simulator have no weights: their "parameters" are the
configurations and the Problem arrays. These helpers take numpy arrays,
dicts or any ``_asdict()``-able object (a JAX ``NamedTuple`` included) and
never import jax, so a test can feed both packages the same inputs and the
same warm-start thrust plan.
"""

from __future__ import annotations

import numpy as np
import torch

from dart_planner_tpu_torch.control.geometric import GeometricConfig
from dart_planner_tpu_torch.ops.costs import Problem
from dart_planner_tpu_torch.perception.mapper import MapperConfig
from dart_planner_tpu_torch.planning.se3_mpc import SE3MPCConfig
from dart_planner_tpu_torch.sim.closed_loop import ClosedLoopConfig
from dart_planner_tpu_torch.sim.physics import PhysicsConfig
from dart_planner_tpu_torch.sim.worlds import WorldConfig


def _fields(obj) -> dict:
    if isinstance(obj, dict):
        return dict(obj)
    if hasattr(obj, "_asdict"):
        return dict(obj._asdict())
    raise TypeError(f"expected a dict or a NamedTuple, got {type(obj).__name__}")


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
