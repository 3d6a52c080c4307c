"""The fused SE(3) MPC solve on the GPU: wrapper of the hand-written CUDA
kernel ``csrc/mpc_solve.cu`` (counterpart of
:mod:`dart_planner_tpu.ops.pallas_mpc`).

:func:`solve_thrusts_fused` runs the whole projected-Newton solve of a batch
in one launch and returns ``(thrusts, min_improvement, positions,
velocities, cost)`` with the JAX package's shapes. For tensors on a CUDA
device it launches the kernel or raises; only for tensors on the CPU does it
run :func:`solve_thrusts_plain`, the plain PyTorch Newton loop with the same
signature. ``LAUNCHES`` counts the kernel's launches.

The kernel applies the rollout maps S_p/m, S_v/m, their transposes and the
quadratic Hessian as warp scans (``csrc/mpc_solve.cu``;
:func:`~dart_planner_tpu_torch.ops.dynamics.apply_structured` is the same
identity in plain PyTorch). Its only constants are two step vectors, built
once per configuration and device on the host in float64, cast to float32
and uploaded.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from dart_planner_tpu_torch.ops import _build, costs, dynamics

SOURCE = "dart_planner_tpu_torch/csrc/mpc_solve.cu"
REPLACES = "dart_planner_tpu/ops/pallas_mpc.py:806"

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)

MAX_HORIZON = 64  # the kernel holds at most two horizon steps per lane
_MAX_ALPHAS = 8

_c_int, _c_float, _c_void_p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p


class _Params(ctypes.Structure):
    """Mirror of ``struct MpcParams`` in ``csrc/mpc_solve.cu``."""

    _fields_ = [
        (name, _c_int)
        for name in (
            "B", "N", "K", "n_gn", "n_full", "cg_iters", "n_alpha",
            "use_obstacles", "use_ground", "use_vel_hinge", "use_tilt",
            "use_tnorm",
        )
    ] + [("alphas", _c_float * _MAX_ALPHAS)] + [
        (name, _c_float)
        for name in (
            "inv_m", "hover", "g_z", "w_p", "w_pN", "w_v", "w_a", "w_T",
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
    lib.mpc_solve_launch.restype = _c_int
    lib.mpc_solve_launch.argtypes = [ctypes.POINTER(_Params)] + [_c_void_p] * 14
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
    k >= N."""
    N = config.prediction_horizon
    LD = lane_stride(N)
    _, _, t = dynamics.rollout_matrices(N, float(config.dt))
    H = costs.quadratic_hessian(
        N, config.dt, config.mass, config.gravity, config.weights
    )
    out = torch.zeros(2, LD, dtype=torch.float32)
    for row, v in enumerate((t, np.diagonal(H))):
        out[row, :N] = torch.tensor(np.array(v), dtype=torch.float32)
    return out.reshape(-1)


@functools.lru_cache(maxsize=32)
def _constants(config, device: str) -> torch.Tensor:
    return constants_host(config).to(device)


def _params(config, B: int, K: int, use_obstacles: bool) -> _Params:
    w = config.weights
    alphas = tuple(config.line_search_alphas)
    if len(alphas) > _MAX_ALPHAS:
        raise ValueError(f"at most {_MAX_ALPHAS} line-search alphas, got {len(alphas)}")
    n_gn, n_full = stage_counts(config)
    lb, ub = config.thrust_bound_values()
    P = _Params(
        B=B, N=config.prediction_horizon, K=K, n_gn=n_gn, n_full=n_full,
        cg_iters=config.cg_iterations, n_alpha=len(alphas),
        use_obstacles=int(use_obstacles), use_ground=int(w.ground > 0.0),
        use_vel_hinge=int(w.velocity_bound > 0.0), use_tilt=int(w.tilt > 0.0),
        use_tnorm=int(w.thrust_norm > 0.0),
        inv_m=1.0 / config.mass, hover=config.hover_thrust,
        g_z=-config.gravity, w_p=w.position,
        w_pN=w.position * (1.0 + w.terminal), w_v=w.velocity,
        w_a=w.acceleration, w_T=w.thrust, w_obs=w.obstacle, w_g=w.ground,
        z_min=w.ground_altitude, w_vb=w.velocity_bound, v_max=w.max_velocity,
        w_tilt=w.tilt, tan_max=w.tan_max_tilt, w_tn=w.thrust_norm,
        u_max=w.max_thrust_norm, dt=config.dt,
    )
    P.alphas[: len(alphas)] = alphas
    P.lb[:] = lb
    P.ub[:] = ub
    return P


def solve_thrusts_plain(config, prob: costs.Problem, u_init: torch.Tensor,
                        use_obstacles: bool = True) -> tuple:
    """The plain PyTorch version of :func:`solve_thrusts_fused`: the Newton
    loop of ``planning.se3_mpc``, then an exact rollout and cost of the
    final iterate. Same signature and outputs, on any device."""
    from dart_planner_tpu_torch.planning import se3_mpc

    if not use_obstacles:
        prob = se3_mpc._strip_obstacles(prob)
    u, min_improvement = se3_mpc._newton_iterate(config, prob, u_init, use_obstacles)
    gvec = se3_mpc._gravity(config, u.dtype, u.device)
    pos, vel, _ = dynamics.rollout_linear(
        u, prob.p0, prob.v0, config.dt, config.mass, gvec
    )
    cost = costs.condensed_cost(
        u, prob, config.weights, config.dt, config.mass, gvec
    )
    return u, min_improvement, pos, vel, cost


def solve_thrusts_fused(config, prob: costs.Problem, u_init: torch.Tensor,
                        use_obstacles: bool = True) -> tuple:
    """Run the fused solve; returns ``(thrusts, min_improvement, positions,
    velocities, cost)``: thrusts/positions/velocities have ``u_init``'s
    shape, min_improvement and cost are batch-shaped.

    Accepts any leading batch shape; shared Problem fields (one goal, one
    obstacle set for the batch) are broadcast to contiguous per-scenario
    copies before the launch. On CUDA tensors it launches the kernel on the
    current stream (no synchronization) or raises; on CPU tensors it runs
    :func:`solve_thrusts_plain`."""
    global LAUNCHES
    if u_init.device.type != "cuda":
        return solve_thrusts_plain(config, prob, u_init, use_obstacles)
    device = u_init.device
    for name, x in zip(prob._fields, prob):
        if x is not None and x.device != device:
            raise ValueError(f"Problem.{name} is on {x.device}, u_init on {device}")
    if u_init.dtype != torch.float32:
        raise TypeError(f"the CUDA solve takes float32, got {u_init.dtype}")
    N = config.prediction_horizon
    if N > MAX_HORIZON:
        raise ValueError(f"the CUDA solve takes N <= {MAX_HORIZON}, got {N}")
    if tuple(u_init.shape[-2:]) != (N, 3):
        raise ValueError(f"u_init must end in ({N}, 3), got {tuple(u_init.shape)}")
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
    if B > 0:
        lib = _library()
        params = _params(config, B, K, use_obstacles)
        consts = _constants(config, str(device))
        # the tensors' card is made current for the launch: the runtime
        # launches on the current device, and the kernel's shared-memory
        # attribute is set per device
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.mpc_solve_launch(
                ctypes.byref(params), consts.data_ptr(), u0.data_ptr(),
                p0.data_ptr(), v0.data_ptr(), goal.data_ptr(), obs.data_ptr(),
                mask.data_ptr(), None if vcap is None else vcap.data_ptr(),
                u_out.data_ptr(), pos_out.data_ptr(), vel_out.data_ptr(),
                imp_out.data_ptr(), cost_out.data_ptr(), stream,
            )
        if err != 0:
            raise RuntimeError(
                f"mpc_solve launch failed: CUDA error {err} "
                f"({lib.mpc_error_string(err).decode()})"
            )
        LAUNCHES += 1

    def rows(x):
        return x.reshape(batch_shape + (N, 3))

    return (
        rows(u_out),
        imp_out.reshape(batch_shape),
        rows(pos_out),
        rows(vel_out),
        cost_out.reshape(batch_shape),
    )
