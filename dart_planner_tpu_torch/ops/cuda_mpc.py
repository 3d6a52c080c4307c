"""The fused SE(3) MPC solve on the GPU: wrapper of the hand-written CUDA
kernel ``csrc/mpc_solve.cu`` (counterpart of
:mod:`dart_planner_tpu.ops.pallas_mpc`).

:func:`solve_thrusts_fused` runs the whole projected-Newton solve of a batch
in one launch and returns a :class:`ThrustSolve` with the JAX package's
shapes, and with ``with_grad`` the projected-gradient norm of the final
iterate, computed by the kernel in the same launch. It takes tensors on a
CUDA device and launches the kernel or raises; the plain PyTorch twin with
the same signature is ``planning.se3_mpc.solve_thrusts_plain``, and
``se3_mpc`` alone chooses between the two. ``LAUNCHES`` counts the kernel's
launches; the global metrics counter ``b1_launches`` counts them by the
solve's pass and the kernel's arm (:func:`run_library`).

The kernel applies the rollout maps S_p/m, S_v/m, their transposes and the
quadratic Hessian as warp scans (``csrc/mpc_solve.cu``;
:func:`~dart_planner_tpu_torch.ops.dynamics.apply_structured` is the same
identity in plain PyTorch). Its only constants are two step vectors and the
line search's alphas, built once per configuration and device on the host
(the vectors in float64), cast to float32 and uploaded
(:mod:`.device_constants`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from dart_planner_tpu_torch.ops import _build, costs, dynamics
from dart_planner_tpu_torch.ops.device_constants import device_constant

SOURCE = "dart_planner_tpu_torch/csrc/mpc_solve.cu"
REPLACES = "dart_planner_tpu/ops/pallas_mpc.py:806"

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)

_c_int, _c_float, _c_void_p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p


class ThrustSolve(NamedTuple):
    """One fixed-budget solve of a batch's thrusts, by the kernel or by its
    plain twin: thrusts, positions and velocities have the initial plan's
    shape, the rest are batch-shaped. ``min_improvement`` is the minimum
    relative cost decrease over the final Newton stage; positions,
    velocities and cost are the exact rollout and cost of the final thrusts;
    ``grad_norm``, their projected-gradient norm
    ``||clamp(u - g, lb, ub) - u||``, is ``None`` where none was asked for."""

    thrusts: torch.Tensor
    min_improvement: torch.Tensor
    positions: torch.Tensor
    velocities: torch.Tensor
    cost: torch.Tensor
    grad_norm: Optional[torch.Tensor]


class _Params(ctypes.Structure):
    """Mirror of ``struct MpcParams`` in ``csrc/mpc_solve.cu``."""

    _fields_ = [
        (name, _c_int)
        for name in (
            "B", "N", "K", "n_gn", "n_full", "cg_iters", "n_alpha",
            "use_obstacles", "use_ground", "use_vel_hinge", "use_tilt",
            "use_tnorm",
        )
    ] + [
        (name, _c_float)
        for name in (
            "inv_m", "inv_m_lo", "hover", "g_z", "w_p", "w_pN", "w_v", "w_a", "w_T",
            "w_obs", "w_g", "z_min", "w_vb", "v_max", "w_tilt", "tan_max",
            "w_tn", "u_max",
        )
    ] + [("lb", _c_float * 3), ("ub", _c_float * 3), ("dt", _c_float)]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of ``mpc_solve_launch`` on a loaded library."""
    lib.mpc_params_size.restype = _c_int
    lib.mpc_params_size.argtypes = []
    lib.mpc_error_string.restype = ctypes.c_char_p
    lib.mpc_error_string.argtypes = [_c_int]
    lib.mpc_scratch_floats.restype = ctypes.c_longlong
    lib.mpc_scratch_floats.argtypes = [ctypes.POINTER(_Params)]
    for name in ("mpc_scenarios_per_warp", "mpc_resident_warps"):
        getattr(lib, name).restype = _c_int
        getattr(lib, name).argtypes = [ctypes.POINTER(_Params)]
    lib.mpc_solve_launch.restype = _c_int
    lib.mpc_solve_launch.argtypes = [ctypes.POINTER(_Params)] + [_c_void_p] * 17
    return lib


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = bind(_build.load())
    if lib.mpc_params_size() != ctypes.sizeof(_Params):
        raise RuntimeError(
            f"MpcParams layout mismatch: C {lib.mpc_params_size()} bytes, "
            f"ctypes {ctypes.sizeof(_Params)}"
        )
    return lib


def stage_counts(config) -> tuple[int, int]:
    """(Gauss-Newton rounds, full-curvature rounds) of one solve."""
    if not config.newton_full_curvature:
        return config.max_iterations, 0
    warmup = min(config.gn_warmup_iterations, config.max_iterations)
    return warmup, config.max_iterations - warmup


def lane_stride(N: int) -> int:
    """Leading dimension of the kernel's per-step arrays (32 per lane step)."""
    return 32 * math.ceil(N / 32)


def constants_host(config) -> torch.Tensor:
    """The kernel's constant block, float32 on the CPU: the step vectors t
    (``k dt``) and diag(H), each ``lane_stride(N)`` long and zero at steps
    k >= N, then ``config.line_search_alphas`` (any count of them)."""
    N = config.prediction_horizon
    LD = lane_stride(N)
    _, _, t = dynamics.rollout_matrices(N, float(config.dt))
    H = costs.quadratic_hessian(
        N, config.dt, config.mass, config.gravity, config.weights
    )
    out = torch.zeros(2, LD, dtype=torch.float32)
    for row, v in enumerate((t, np.diagonal(H))):
        out[row, :N] = torch.tensor(np.array(v), dtype=torch.float32)
    alphas = torch.tensor(config.line_search_alphas, dtype=torch.float32).reshape(-1)
    return torch.cat([out.reshape(-1), alphas])


def _constants_on(config, *, dtype, device) -> torch.Tensor:
    return constants_host(config).to(device=device, dtype=dtype)


def _params(config, B: int, K: int, use_obstacles: bool) -> _Params:
    w = config.weights
    n_gn, n_full = stage_counts(config)
    lb, ub = config.thrust_bound_values()
    inv_m = 1.0 / config.mass
    P = _Params(
        B=B, N=config.prediction_horizon, K=K, n_gn=n_gn, n_full=n_full,
        cg_iters=config.cg_iterations, n_alpha=len(config.line_search_alphas),
        use_obstacles=int(use_obstacles), use_ground=int(w.ground > 0.0),
        use_vel_hinge=int(w.velocity_bound > 0.0), use_tilt=int(w.tilt > 0.0),
        use_tnorm=int(w.thrust_norm > 0.0),
        inv_m=inv_m, inv_m_lo=inv_m - float(np.float32(inv_m)), hover=config.hover_thrust,
        g_z=-config.gravity, w_p=w.position,
        w_pN=w.position * (1.0 + w.terminal), w_v=w.velocity,
        w_a=w.acceleration, w_T=w.thrust, w_obs=w.obstacle, w_g=w.ground,
        z_min=w.ground_altitude, w_vb=w.velocity_bound, v_max=w.max_velocity,
        w_tilt=w.tilt, tan_max=w.tan_max_tilt, w_tn=w.thrust_norm,
        u_max=w.max_thrust_norm, dt=config.dt,
    )
    P.lb[:] = lb
    P.ub[:] = ub
    return P


def exact_cost(config, prob: costs.Problem, u: torch.Tensor) -> torch.Tensor:
    """The cost of thrusts ``u`` evaluated in float64 from the same float32
    inputs the kernel takes (the problem, the float32 gravity): the
    reference for the kernel's float32 cost pass, on ``u``'s device."""
    p64 = costs.Problem(*[x.double() if x is not None and x.dtype.is_floating_point else x
                          for x in prob])
    g = torch.tensor([0.0, 0.0, -config.gravity], dtype=torch.float32, device=u.device)
    return costs.condensed_cost(u.double(), p64, config.weights, config.dt, config.mass,
                                g.double())


def solve_thrusts_fused(config, prob: costs.Problem, u_init: torch.Tensor,
                        use_obstacles: bool = True, solve_pass: str = "phase1",
                        with_grad: bool = False) -> ThrustSolve:
    """Run the fused solve in one launch. With ``with_grad`` the kernel
    computes the projected-gradient norm after its final rollout (a launch
    without it skips that pass; its other outputs are the same bit for
    bit). ``solve_pass`` names the pass of ``se3_mpc.solve`` that launches
    it (``"phase1"``, ``"tail"``, ``"restart"``) for the launch counter and
    the wrapper's span histories (:func:`run_library`).

    Accepts any leading batch shape; shared Problem fields (one goal, one
    obstacle set for the batch) are broadcast to contiguous per-scenario
    copies before the launch. It launches the kernel on the current stream
    of the tensors' CUDA device (no synchronization) or raises, on CPU
    tensors too."""
    if u_init.device.type != "cuda":
        raise ValueError(
            f"the fused solve needs tensors on a CUDA device, got {u_init.device}; "
            "the plain loop is se3_mpc.solve_thrusts_plain (method='torch')"
        )
    device = u_init.device
    for name, x in zip(prob._fields, prob):
        if x is not None and x.device != device:
            raise ValueError(f"Problem.{name} is on {x.device}, u_init on {device}")
    if u_init.dtype != torch.float32:
        raise TypeError(f"the CUDA solve takes float32, got {u_init.dtype}")
    N = config.prediction_horizon
    if tuple(u_init.shape[-2:]) != (N, 3):
        raise ValueError(f"u_init must end in ({N}, 3), got {tuple(u_init.shape)}")
    # the tensors' card is made current for the launch: the runtime
    # launches on the current device, and the kernel's shared-memory
    # attribute is set per device
    with torch.cuda.device(device):
        return run_library(_library, config, prob, u_init, use_obstacles,
                           torch.cuda.current_stream(device).cuda_stream, solve_pass,
                           with_grad)


def order_mask(prob: costs.Problem, batch_shape: tuple, use_obstacles: bool,
               per_warp: int) -> Optional[torch.Tensor]:
    """The batch's sphere mask as (B, K) where a launch on an arm of
    ``per_warp`` scenarios a warp (the library's ``mpc_scenarios_per_warp``)
    is to take the batch in order of its live spheres (:func:`run_library`):
    on the packed arm (more than one: N <= 32 past one wave of one scenario
    a warp), with spheres in use and a mask that differs by scenario. Else
    None, with no tensor operation: the other arms take no order, and
    without spheres or with one mask for the batch
    (:func:`costs.batch_shared`) every key is equal."""
    K = prob.obstacles.shape[-2]
    m = prob.obstacle_mask
    if not use_obstacles or K == 0 or per_warp <= 1 or costs.batch_shared(m, m.ndim - 1):
        return None
    return m.expand(batch_shape + (K,)).reshape(math.prod(batch_shape), K)


def run_library(library, config, prob: costs.Problem, u_init: torch.Tensor,
                use_obstacles: bool, stream, solve_pass: str = "phase1",
                with_grad: bool = False) -> ThrustSolve:
    """One launch through ``library()``, a library with the C interface of
    ``csrc/mpc_solve.cu``, on ``stream``: the inputs flattened to contiguous
    float32 per-scenario copies, the outputs allocated beside them and
    shaped as :func:`solve_thrusts_fused` returns them (the norm only with
    ``with_grad``: else the launch passes no pointer for it), and, where the
    library asks for it (from five horizon steps a lane, when a warp's arena
    does not fit the card's shared memory), a float32 scratch of its size.
    Raises if the launch fails; an empty batch launches nothing. A launch on
    a CUDA stream adds one to ``LAUNCHES``; ``stream=None`` (a library built
    for the CPU) does not. Every launch adds one, on the host, to the global
    metrics counter ``b1_launches`` under the labels ``pass`` (``solve_pass``),
    ``steps`` (``ceil(N / 32)``: 2-4 are compiled arms, from 5 on one arm
    reads the count at run time), ``arena`` (``"global"`` where the warps'
    arena lies in the global scratch, else ``"shared"``) and ``per_warp``
    (scenarios a warp, ``mpc_scenarios_per_warp``: 4 on the packed arm that
    takes every N <= 32, else 1). Where :func:`order_mask` gives a mask
    (the packed arm, spheres in use) the launch passes the kernel an order
    of the batch by each scenario's live spheres, descending and stable,
    built on the tensors' device with nothing read back (the span
    ``b1.order``): a warp runs its sphere loops and CG steps until its
    longest scenario is done and a block's warps retire together, so alike
    scenarios side by side waste the least. The kernel reads each
    scenario's inputs and writes its outputs in the batch's own order, and
    a scenario's outputs depend on no other's, so they are the same bit for
    bit in any order. Timed whole as the span ``b1.wrapper``, whose
    milliseconds also go into the history ``b1.wrapper.<solve_pass>``."""
    global LAUNCHES
    from dart_planner_tpu_torch.common.metrics import get_metrics, span  # common shares ops' layer

    wrapper = span("b1.wrapper")
    with wrapper:
        device = u_init.device
        N = config.prediction_horizon
        batch_shape = tuple(u_init.shape[:-2])
        B = math.prod(batch_shape)
        K = prob.obstacles.shape[-2]

        def flat(x, trailing):
            x = x.to(torch.float32).expand(batch_shape + trailing)
            return x.reshape((B,) + trailing).contiguous()

        u0 = flat(u_init, (N, 3))
        p0 = flat(prob.p0, (3,))
        v0 = flat(prob.v0, (3,))
        if prob.goal.ndim == prob.p0.ndim + 1:  # per-step reference
            goal = flat(prob.goal, (N, 3))
        else:
            goal = flat(prob.goal, (3,))[:, None, :].expand(B, N, 3).contiguous()
        obs = flat(prob.obstacles, (K, 4))
        mask = flat(prob.obstacle_mask, (K,))
        vcap = None if prob.v_cap is None else flat(prob.v_cap, ())

        u_out = torch.empty((B, N, 3), dtype=torch.float32, device=device)
        pos_out = torch.empty_like(u_out)
        vel_out = torch.empty_like(u_out)
        imp_out = torch.empty((B,), dtype=torch.float32, device=device)
        cost_out = torch.empty_like(imp_out)
        gnorm_out = torch.empty_like(imp_out) if with_grad else None
        if B > 0:
            lib = library()
            params = _params(config, B, K, use_obstacles)
            consts = device_constant(_constants_on, config, dtype=torch.float32, device=device)
            per_warp = lib.mpc_scenarios_per_warp(ctypes.byref(params))
            live = order_mask(prob, batch_shape, use_obstacles, per_warp)
            order = None
            if live is not None:
                with span("b1.order"):
                    order = torch.argsort(live.sum(-1, dtype=torch.int32), descending=True,
                                          stable=True)
            n_scratch = lib.mpc_scratch_floats(ctypes.byref(params))
            if n_scratch < 0:
                err = -n_scratch
            else:
                scratch = (torch.empty(n_scratch, dtype=torch.float32, device=device)
                           if n_scratch else None)
                err = lib.mpc_solve_launch(
                    ctypes.byref(params), consts.data_ptr(), u0.data_ptr(),
                    p0.data_ptr(), v0.data_ptr(), goal.data_ptr(), obs.data_ptr(),
                    mask.data_ptr(), None if vcap is None else vcap.data_ptr(),
                    u_out.data_ptr(), pos_out.data_ptr(), vel_out.data_ptr(),
                    imp_out.data_ptr(), cost_out.data_ptr(),
                    None if gnorm_out is None else gnorm_out.data_ptr(),
                    None if scratch is None else scratch.data_ptr(),
                    None if order is None else order.data_ptr(), stream,
                )
            if err != 0:
                raise RuntimeError(
                    f"mpc_solve launch failed: CUDA error {err} "
                    f"({lib.mpc_error_string(err).decode()})"
                )
            if stream is not None:
                LAUNCHES += 1
            get_metrics().increment("b1_launches", labels={
                "pass": solve_pass, "steps": lane_stride(N) // 32,
                "arena": "global" if n_scratch else "shared",
                "per_warp": per_warp})

        def rows(x):
            return x.reshape(batch_shape + (N, 3))

        out = ThrustSolve(rows(u_out), imp_out.reshape(batch_shape), rows(pos_out), rows(vel_out),
                          cost_out.reshape(batch_shape),
                          None if gnorm_out is None else gnorm_out.reshape(batch_shape))
    get_metrics().record(f"b1.wrapper.{solve_pass}", wrapper.ms)
    return out
