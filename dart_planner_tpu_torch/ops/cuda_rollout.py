"""The closed-loop tick block on the GPU: wrapper of the hand-written CUDA
kernel ``csrc/tick_block.cu`` (counterpart of
:mod:`dart_planner_tpu.ops.pallas_rollout`).

One replan block of the closed-loop simulator runs ``T`` control ticks
(geometric SE(3) controller, then the rigid-body plant over its substeps)
at 400 Hz between two 10 Hz MPC replans. :func:`run_tick_block` runs the
whole block in one launch over a batch of episodes. For tensors on a CUDA
device it launches the kernel or raises; only for tensors on the CPU does
it run :func:`run_tick_block_plain`, the same tick loop in PyTorch over the
same rows. ``LAUNCHES`` counts the kernel's launches.

The kernel keeps each tick's positions in shared memory for its metrics
pass, so one launch takes at most :func:`max_ticks` ticks (601 on an
H100). A block of more ticks runs as consecutive launches of at most that
many (:func:`tick_chunks`), the state rows chained from one to the next,
each launch on its slice of the setpoint rows; the metrics combine as one
launch's would (minima by minimum, the tracking sum by sum, launch by
launch). The plain version chunks the same way, on the CPU as an H100
would. The launch's parameter struct and the setpoints' interpolation
weights on the device are built once per configuration and shape, and
then reused.

Scope: every controller configuration of the JAX package's closed loop:
clamping or back-calculation anti-windup, the ``"lee"`` or ``"reference"``
yaw convention (setpoint yaw and yaw rate 0, as the simulator commands),
any number of physics substeps and ticks; one batch axis (the closed loop
flattens others).

State rows (one (32, B) tensor):
  0-2 pos | 3-5 vel | 6-8 omega | 9-17 R row-major | 18-20 integral |
  21-23 last_torque_saturated | 24 failsafe_count | 25 last_valid_thrust |
  26 unsaturated_thrust, 27-29 unsaturated_torque (back-calculation only;
  zero under clamping, as the JAX package packs them) | 30-31 zero
Accumulator rows (8, B): 0 min goal distance | 1 summed squared tracking
error | 2 min altitude | 3 min sphere surface clearance (1e30 without
spheres) | 4-7 zero.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from dart_planner_tpu_torch.ops import _build
from dart_planner_tpu_torch.ops.device_constants import device_constant

SOURCE = "dart_planner_tpu_torch/csrc/tick_block.cu"
REPLACES = "dart_planner_tpu/ops/pallas_rollout.py:357"

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)

ROWS = 32
ACC_ROWS = 8
INACTIVE_RADIUS = -1e30  # an inactive sphere's radius: its clearance is ~1e30
EPISODES_PER_BLOCK = 32  # the kernel's block: one chain warp of 32 episodes
WARPS_PER_BLOCK = 4  # the chain warp and three helpers for the metrics pass
DEFAULT_SHARED_BYTES = 48 * 1024  # what a block may take without opting in

_c_int, _c_float, _c_void_p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
_INTS = ("B", "T", "substeps", "K", "use_drag", "back_calc", "ref_yaw")
_VEC3 = ("kp", "ki", "kd", "kp_att", "kd_att", "inertia", "max_tq",
         "per_axis_int", "near_int", "p_inertia")
_FLOATS = ("mass", "g", "min_thrust", "max_thrust", "cos_max", "sin_max",
           "max_integral_pos", "decay", "yaw_sing", "track_thr", "vel_thr",
           "fs_trigger", "p_mass", "pg", "p_max_thrust", "p_max_torque",
           "drag", "control_dt", "h", "kb")
BACK_CALC_SPLIT = (0.33, 0.33, 0.34)  # thrust feedback's share per axis (JAX)
H100_SHARED_LIMIT = 232448  # the shared memory an H100 gives a block on opt-in


class _Params(ctypes.Structure):
    """Mirror of ``struct TickParams`` in ``csrc/tick_block.cu``."""

    _fields_ = ([(name, _c_int) for name in _INTS]
                + [(name, _c_float * 3) for name in _VEC3]
                + [(name, _c_float) for name in _FLOATS])


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of ``tick_block_launch`` on a loaded library
    (the package's build, or an earlier build of ``csrc/tick_block.cu`` with
    the same interface) and check its ``TickParams`` layout."""
    lib.tick_params_size.restype = _c_int
    lib.tick_params_size.argtypes = []
    lib.tick_error_string.restype = ctypes.c_char_p
    lib.tick_error_string.argtypes = [_c_int]
    lib.tick_block_launch.restype = _c_int
    lib.tick_block_launch.argtypes = [ctypes.POINTER(_Params)] + [_c_void_p] * 9
    if lib.tick_params_size() != ctypes.sizeof(_Params):
        raise RuntimeError(
            f"TickParams layout mismatch: C {lib.tick_params_size()} bytes, "
            f"ctypes {ctypes.sizeof(_Params)}"
        )
    return lib


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    return bind(_build.load())


def shared_bytes(T: int) -> int:
    """Dynamic shared memory of one block of the kernel at ``T`` ticks: the
    position after each tick and each warp's three partial minima, for
    ``EPISODES_PER_BLOCK`` episodes. ``tick_block_launch`` sizes each
    launch itself, by its own T; this count lets the wrapper split a block
    before any launch (:func:`tick_chunks`)."""
    return 4 * EPISODES_PER_BLOCK * (3 * T + 3 * WARPS_PER_BLOCK)


def max_ticks(limit_bytes: int) -> int:
    """The largest T whose block fits in ``limit_bytes`` of shared memory."""
    return (limit_bytes // (4 * EPISODES_PER_BLOCK) - 3 * WARPS_PER_BLOCK) // 3


@functools.lru_cache(maxsize=None)
def shared_limit(device: torch.device) -> int:
    """Shared memory a block may opt in to on ``device``, in bytes; for a
    device that is not a card, an H100's, so that the plain version on the
    CPU chunks a block as the kernel does on an H100."""
    if device.type != "cuda":
        return H100_SHARED_LIMIT
    return torch.cuda.get_device_properties(device).shared_memory_per_block_optin


def ticks_fit(T: int, device: torch.device) -> bool:
    """Whether a block of ``T`` ticks fits the shared memory ``device`` gives
    one launch; the card is asked only above the 48 KB that every card gives."""
    need = shared_bytes(T)
    return need <= DEFAULT_SHARED_BYTES or need <= shared_limit(device)


def tick_chunks(T: int, device: torch.device) -> tuple[int, ...]:
    """The ticks of each launch that a block of ``T`` ticks takes on
    ``device``: ``(T,)`` when it fits one launch, else as many launches of
    :func:`max_ticks` as fit and one of the rest. The launches a replan
    takes are ``ceil(T / max_ticks)``."""
    if ticks_fit(T, device):
        return (T,)
    m = max_ticks(shared_limit(device))
    return (m,) * (T // m) + ((T % m,) if T % m else ())


def combine_metrics(acc: torch.Tensor, more: torch.Tensor) -> torch.Tensor:
    """The accumulator rows of two consecutive launches as one launch's:
    the minima by minimum, the tracking sum by sum, rows 4-7 zero."""
    return torch.stack([
        torch.minimum(acc[0], more[0]), acc[1] + more[1],
        torch.minimum(acc[2], more[2]), torch.minimum(acc[3], more[3]), *acc[4:],
    ])


def _scalars(control_cfg, physics_cfg, control_dt: float, substeps: int) -> dict:
    """The block's constants as Python floats, each computed on the host in
    float64 as the JAX kernel computes them (the kernel and the plain
    version both round them to float32)."""
    c, p = control_cfg, physics_cfg
    per_axis = tuple(float(v) for v in c.max_integral_per_axis)
    return dict(
        kp=tuple(float(v) for v in c.kp_pos),
        ki=tuple(float(v) for v in c.ki_pos),
        kd=tuple(float(v) for v in c.kd_pos),
        kp_att=tuple(float(v) for v in c.kp_att),
        kd_att=tuple(float(v) for v in c.kd_att),
        inertia=tuple(float(v) for v in c.inertia),
        max_tq=tuple(float(v) for v in c.max_torque_xyz),
        per_axis_int=per_axis,
        near_int=tuple(v * c.saturation_threshold for v in per_axis),
        p_inertia=tuple(float(v) for v in p.inertia),
        mass=float(c.mass),
        g=float(c.gravity),
        min_thrust=float(c.min_thrust) * float(c.mass) * float(c.gravity),
        max_thrust=float(c.max_thrust),
        cos_max=float(np.cos(c.max_tilt_angle)),
        sin_max=float(np.sin(c.max_tilt_angle)),
        max_integral_pos=float(c.max_integral_pos),
        decay=float(c.integral_decay_factor),
        yaw_sing=float(c.yaw_singularity_threshold),
        track_thr=float(c.tracking_error_threshold),
        vel_thr=float(c.velocity_error_threshold),
        fs_trigger=float(c.failsafe_trigger_count),
        p_mass=float(p.mass),
        pg=float(p.gravity),
        p_max_thrust=float(p.max_thrust),
        p_max_torque=float(p.max_torque),
        drag=float(p.drag_coefficient),
        control_dt=float(control_dt),
        h=float(control_dt) / substeps,
        kb=float(c.back_calculation_gain),
        # the JAX controller's arms: anything but "clamping" back-calculates,
        # anything but "reference" is Lee's frame
        back_calc=back_calculation(c),
        ref_yaw=c.yaw_convention == "reference",
    )


def back_calculation(control_cfg) -> bool:
    """Whether ``control_cfg`` takes the back-calculation anti-windup arm
    (the JAX controller's test: every method but "clamping")."""
    return control_cfg.anti_windup_method != "clamping"


def _params(s: dict, B: int, T: int, substeps: int, K: int) -> _Params:
    P = _Params(B=B, T=T, substeps=substeps, K=K, use_drag=int(s["drag"] > 0),
                back_calc=int(s["back_calc"]), ref_yaw=int(s["ref_yaw"]))
    for name in _VEC3:
        getattr(P, name)[:] = s[name]
    for name in _FLOATS:
        setattr(P, name, s[name])
    return P


@functools.lru_cache(maxsize=64)
def _launch_params(control_cfg, physics_cfg, control_dt: float, T: int, substeps: int,
                   B: int, K: int) -> _Params:
    """The launch's parameter struct, built once per configuration and
    shape (the configs are NamedTuples of floats, strings and tuples)."""
    return _params(_scalars(control_cfg, physics_cfg, control_dt, substeps),
                   B, T, substeps, K)


def _lerp_weights(T: int, control_dt: float, mpc_dt: float, N: int) -> np.ndarray:
    """Static (T, N) linear-interpolation matrix: plan -> per-tick setpoint."""
    W = np.zeros((T, N), np.float32)
    for j in range(T):
        tau = (j + 1) * control_dt
        x = min(max(tau / mpc_dt, 0.0), N - 1.001)
        i0 = int(np.floor(x))
        frac = x - i0
        W[j, i0] = 1.0 - frac
        W[j, i0 + 1] += frac
    return W


def _lerp_on(T: int, control_dt: float, mpc_dt: float, N: int, *, dtype,
             device) -> torch.Tensor:
    return torch.as_tensor(_lerp_weights(T, control_dt, mpc_dt, N), dtype=dtype,
                           device=device)


def _lerp_tensor(T: int, control_dt: float, mpc_dt: float, N: int, dtype: torch.dtype,
                 device) -> torch.Tensor:
    """:func:`_lerp_weights` on ``device``, copied there once per shape
    (:mod:`.device_constants`; read only)."""
    return device_constant(_lerp_on, T, control_dt, mpc_dt, N, dtype=dtype, device=device)


def pack_state(rb, ctrl, back_calc: bool = False) -> torch.Tensor:
    """RigidBodyState + ControllerState (leading batch (B,)) -> (32, B).
    ``back_calc`` (the configuration's arm, :func:`back_calculation`) packs
    the unsaturated thrust and torque into rows 26-29; without it those rows
    are zero, as the JAX package packs them."""
    B = rb.position.shape[0]
    dtype = rb.position.dtype
    rows = [
        rb.position.T,
        rb.velocity.T,
        rb.angular_velocity.T,
        rb.rotation.reshape(B, 9).T,
        ctrl.integral_vel_error.T,
        ctrl.last_torque_saturated.to(dtype).T,
        ctrl.failsafe_count.to(dtype)[None, :],
        ctrl.last_valid_thrust[None, :],
    ]
    if back_calc:
        rows += [ctrl.unsaturated_thrust[None, :], ctrl.unsaturated_torque.T]
    S = torch.cat(rows, dim=0)
    pad = torch.zeros((ROWS - S.shape[0], B), dtype=dtype, device=S.device)
    return torch.cat([S, pad], dim=0)


def unpack_state(S: torch.Tensor, rb_template, ctrl_template, back_calc: bool = False):
    """(32, B) -> (RigidBodyState, ControllerState) matching the templates;
    ``back_calc`` as :func:`pack_state`'s (the unsaturated thrust and torque
    come from rows 26-29, else from the template)."""
    B = S.shape[1]
    rb = rb_template.replace(
        position=S[0:3].T,
        velocity=S[3:6].T,
        rotation=S[9:18].T.reshape(B, 3, 3),
        angular_velocity=S[6:9].T,
    )
    ctrl = ctrl_template.replace(
        integral_vel_error=S[18:21].T,
        last_torque_saturated=S[21:24].T > 0.5,
        failsafe_count=S[24].to(torch.int32),
        failsafe_active=S[24] > 0.0,  # informational
        last_valid_thrust=S[25],
    )
    if back_calc:
        ctrl = ctrl.replace(unsaturated_thrust=S[26], unsaturated_torque=S[27:30].T)
    return rb, ctrl


def pack_obstacles(obstacles: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, K, 4) spheres + (B, K) mask -> (4K, B) kernel rows; inactive
    spheres get r = -1e30 so their clearance never wins the minimum."""
    r = torch.where(mask, obstacles[..., 3], INACTIVE_RADIUS)
    rows = torch.cat([obstacles[..., :3], r[..., None]], dim=-1)
    B, K = rows.shape[0], rows.shape[1]
    return rows.reshape(B, 4 * K).T.contiguous()


def setpoints_from_plan(
    positions: torch.Tensor, velocities: torch.Tensor, accelerations: torch.Tensor,
    T: int, control_dt: float, mpc_dt: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plan arrays (B, N, 3) -> per-tick setpoint rows (3T, B) each (row
    3t+d is axis d at tick t), by a plain float32 einsum."""
    from dart_planner_tpu_torch.common.metrics import span  # common shares ops' layer

    with span("b2.setpoints"):
        W = _lerp_tensor(T, control_dt, mpc_dt, positions.shape[-2], positions.dtype,
                         positions.device)

        def to_rows(arr):
            sp = torch.einsum("tn,bnd->btd", W, arr)
            return sp.reshape(arr.shape[0], 3 * T).T.contiguous()

        return to_rows(positions), to_rows(velocities), to_rows(accelerations)


def run_tick_block_plain(
    control_cfg, physics_cfg, control_dt: float, T: int, substeps: int,
    state_rows: torch.Tensor, sp_pos: torch.Tensor, sp_vel: torch.Tensor,
    sp_acc: torch.Tensor, goal_wind: torch.Tensor,
    obstacle_rows: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`run_tick_block`: the tick loop of
    the JAX controller (``geometric.compute_control``, both anti-windup arms
    and both yaw conventions) and plant over the same rows, each row a (B,)
    tensor, in the kernel's launches (:func:`tick_chunks` on the rows'
    device). Same signature and outputs, any device."""
    s = _scalars(control_cfg, physics_cfg, control_dt, substeps)
    state, acc, t0 = state_rows, None, 0
    for n in tick_chunks(T, state_rows.device):
        rows = slice(3 * t0, 3 * (t0 + n))
        state, more = _plain_launch(s, n, substeps, state, sp_pos[rows], sp_vel[rows],
                                    sp_acc[rows], goal_wind, obstacle_rows)
        acc = more if acc is None else combine_metrics(acc, more)
        t0 += n
    return state, acc


def _plain_launch(s: dict, T: int, substeps: int, S, spp, spv, spa, gw, obs):
    """One launch's ticks of :func:`run_tick_block_plain`: the JAX kernel
    body (``pallas_rollout._tick_kernel``) with its two further arms."""
    control_dt = s["control_dt"]
    K = 0 if obs is None else obs.shape[0] // 4
    kp, ki, kd = s["kp"], s["ki"], s["kd"]
    kp_att, kd_att = s["kp_att"], s["kd_att"]
    inertia, max_tq, p_inertia = s["inertia"], s["max_tq"], s["p_inertia"]
    per_axis, near_int = s["per_axis_int"], s["near_int"]
    cos_max, sin_max = s["cos_max"], s["sin_max"]
    h, pg, p_mass = s["h"], s["pg"], s["p_mass"]
    drag = s["drag"]

    def dot3(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    def cross3(a, b):
        return (
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        )

    def norm3(a):
        return torch.sqrt(dot3(a, a))

    def vec(x, i):
        return (x[i], x[i + 1], x[i + 2])

    def sel(cond, a, b):
        return torch.where(cond, a, b)

    pos, vel, omega = vec(S, 0), vec(S, 3), vec(S, 6)
    R = [[S[9 + 3 * i + j] for j in range(3)] for i in range(3)]
    integral = vec(S, 18)
    lt_sat = vec(S, 21)
    fcount, last_valid = S[24], S[25]
    back_calc, kb = s["back_calc"], s["kb"]
    if back_calc:
        u_thrust, u_torque = S[26], vec(S, 27)
    goal, wind = vec(gw, 0), vec(gw, 3)

    big = torch.full_like(fcount, 1e30)
    min_dist, min_alt, min_clear = big, big, big
    track_sum = torch.zeros_like(fcount)

    for j in range(T):
        sp_p, sp_v, sp_a = vec(spp, 3 * j), vec(spv, 3 * j), vec(spa, 3 * j)

        # geometric controller
        pe = tuple(sp_p[d] - pos[d] for d in range(3))
        ve = tuple(sp_v[d] - vel[d] for d in range(3))
        pe_mag, ve_mag = norm3(pe), norm3(ve)
        acc_des = tuple(
            sp_a[d] + kp[d] * pe[d] + kd[d] * ve[d] + ki[d] * integral[d]
            for d in range(3)
        )
        f = (acc_des[0], acc_des[1], acc_des[2] + s["g"])
        f_norm = norm3(f)
        thrust_raw = s["mass"] * f_norm
        thrust_mag = torch.clamp(thrust_raw, s["min_thrust"], s["max_thrust"])
        thrust_sat = (thrust_raw != thrust_mag).to(S.dtype)

        # integral, with clamping or back-calculation anti-windup; the
        # feedback reads the last tick's raw thrust and torque and this
        # tick's thrust saturation, in the JAX controller's order
        new_int = []
        if back_calc:
            thrust_fb = sel(thrust_sat > 0.5, (u_thrust - s["max_thrust"]) * kb,
                            torch.zeros_like(u_thrust))
        else:
            damp_t = 1.0 - 0.9 * thrust_sat
        for d in range(3):
            if back_calc:
                torque_fb = sel(lt_sat[d] > 0.5, (u_torque[d] - max_tq[d]) * kb,
                                torch.zeros_like(u_thrust))
                upd = ve[d] * control_dt
                upd = upd - thrust_fb * BACK_CALC_SPLIT[d]
                upd = upd - torque_fb * 0.5
                v = integral[d] + upd
            else:
                damp = damp_t * (1.0 - 0.9 * lt_sat[d])
                v = integral[d] + ve[d] * control_dt * damp
            new_int.append(torch.clamp(v, -per_axis[d], per_axis[d]))
        mag = norm3(new_int)
        scale = sel(
            mag > s["max_integral_pos"],
            s["max_integral_pos"] / torch.clamp(mag, min=1e-9),
            torch.ones_like(mag),
        )
        new_int = [v * scale for v in new_int]
        integral = tuple(
            sel(v.abs() > near_int[d], v * s["decay"], v)
            for d, v in enumerate(new_int)
        )

        # desired thrust direction + tilt limit
        inv_f = 1.0 / torch.clamp(f_norm, min=1e-9)
        b3 = tuple(f[d] * inv_f for d in range(3))
        tm_ok = (thrust_mag > 1e-6).to(S.dtype)
        b3 = (b3[0] * tm_ok, b3[1] * tm_ok, b3[2] * tm_ok + (1.0 - tm_ok))
        over = b3[2] < cos_max
        inv_xy = 1.0 / torch.clamp(torch.sqrt(b3[0] * b3[0] + b3[1] * b3[1]), min=1e-9)
        b3 = (
            sel(over, sin_max * b3[0] * inv_xy, b3[0]),
            sel(over, sin_max * b3[1] * inv_xy, b3[1]),
            sel(over, cos_max + 0.0 * b3[2], b3[2]),
        )

        # desired frame at yaw 0 (c = e1): Lee's b1 = (b3 x c) x b3, or the
        # reference's c x b3
        one, zero = torch.ones_like(b3[0]), torch.zeros_like(b3[0])
        e1 = (one, zero, zero)
        singular = b3[0].abs() >= s["yaw_sing"]
        if s["ref_yaw"]:
            b1_raw = cross3((1.0, 0.0, 0.0), b3)
        else:
            b1_raw = cross3(cross3(b3, (1.0, 0.0, 0.0)), b3)
        n1 = norm3(b1_raw)
        ok = n1 > 1e-6
        inv_n1 = 1.0 / sel(ok, n1, one)
        b1_normal = tuple(sel(ok, b1_raw[d] * inv_n1, e1[d]) for d in range(3))
        straight = b3[2].abs() >= 0.99
        proj = (1.0 - b3[0] * b3[0], -b3[0] * b3[1], -b3[0] * b3[2])
        np_ = norm3(proj)
        ok_p = np_ > 1e-9
        inv_np = 1.0 / sel(ok_p, np_, one)
        b1_skip = tuple(
            sel(straight, e1[d], sel(ok_p, proj[d] * inv_np, e1[d])) for d in range(3)
        )
        b1 = tuple(sel(singular, b1_skip[d], b1_normal[d]) for d in range(3))
        Rd_cols = (b1, cross3(b3, b1), b3)

        # e_R = 0.5 vee(Rd^T R - R^T Rd); M[i][j] = col_i(Rd) . col_j(R)
        Rc = [tuple(R[k][j] for k in range(3)) for j in range(3)]
        M = [[dot3(Rd_cols[i], Rc[j]) for j in range(3)] for i in range(3)]
        eR = (
            0.5 * (M[2][1] - M[1][2]),
            0.5 * (M[0][2] - M[2][0]),
            0.5 * (M[1][0] - M[0][1]),
        )
        cor = cross3(omega, tuple(inertia[d] * omega[d] for d in range(3)))
        tq_raw = tuple(
            -kp_att[d] * eR[d] - kd_att[d] * omega[d] + cor[d] for d in range(3)
        )
        tq = tuple(torch.clamp(tq_raw[d], -max_tq[d], max_tq[d]) for d in range(3))
        lt_sat = tuple((tq_raw[d] != tq[d]).to(S.dtype) for d in range(3))
        if back_calc:  # the raw values, latch or not
            u_thrust, u_torque = thrust_raw, tq_raw

        # failsafe accounting
        bad = (pe_mag > s["track_thr"]) & (ve_mag > s["vel_thr"])
        fcount = sel(bad, fcount + 1.0, torch.clamp(fcount - 1.0, min=0.0))
        failsafe = fcount > s["fs_trigger"]
        thrust_out = sel(failsafe, last_valid, thrust_mag)
        tq = tuple(sel(failsafe, zero, tq[d]) for d in range(3))
        integral = tuple(sel(failsafe, zero, integral[d]) for d in range(3))
        last_valid = sel(failsafe, last_valid, thrust_mag)

        # rigid-body plant over the substeps
        thr = torch.clamp(thrust_out, 0.0, s["p_max_thrust"])
        ptq = tuple(
            torch.clamp(tq[d], -s["p_max_torque"], s["p_max_torque"]) for d in range(3)
        )
        for _ in range(substeps):
            b3w = (R[0][2], R[1][2], R[2][2])
            acc = []
            for d in range(3):
                a = b3w[d] * thr / p_mass
                a = a - pg if d == 2 else a
                a = a + wind[d] / p_mass
                if drag > 0:
                    a = a - drag * vel[d]
                acc.append(a)
            vel = tuple(vel[d] + acc[d] * h for d in range(3))
            pos = tuple(pos[d] + vel[d] * h for d in range(3))
            gyro = cross3(omega, tuple(p_inertia[d] * omega[d] for d in range(3)))
            omega = tuple(
                omega[d] + (ptq[d] - gyro[d]) / p_inertia[d] * h for d in range(3)
            )
            # R <- R exp(hat(omega h)), Rodrigues with the small-angle branch
            w = tuple(omega[d] * h for d in range(3))
            t2 = dot3(w, w)
            theta = torch.sqrt(t2)
            small = theta < 1e-5
            a_c = sel(small, 1.0 - t2 / 6.0, torch.sin(theta) / sel(small, one, theta))
            b_c = sel(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(theta)) / sel(small, one, t2))
            wx, wy, wz = w
            E = [
                [1.0 + b_c * (-(wy * wy + wz * wz)), -a_c * wz + b_c * wx * wy,
                 a_c * wy + b_c * wx * wz],
                [a_c * wz + b_c * wx * wy, 1.0 + b_c * (-(wx * wx + wz * wz)),
                 -a_c * wx + b_c * wy * wz],
                [-a_c * wy + b_c * wx * wz, a_c * wx + b_c * wy * wz,
                 1.0 + b_c * (-(wx * wx + wy * wy))],
            ]
            R = [
                [R[i][0] * E[0][j] + R[i][1] * E[1][j] + R[i][2] * E[2][j]
                 for j in range(3)]
                for i in range(3)
            ]

        # per-tick episode metrics
        dist = norm3(tuple(pos[d] - goal[d] for d in range(3)))
        te = tuple(pos[d] - sp_p[d] for d in range(3))
        min_dist = torch.minimum(min_dist, dist)
        min_alt = torch.minimum(min_alt, pos[2])
        track_sum = track_sum + dot3(te, te)
        for k in range(K):
            ov = tuple(pos[d] - obs[4 * k + d] for d in range(3))
            min_clear = torch.minimum(min_clear, norm3(ov) - obs[4 * k + 3])

    rows = (
        list(pos) + list(vel) + list(omega)
        + [R[i][j] for i in range(3) for j in range(3)]
        + list(integral) + list(lt_sat) + [fcount, last_valid]
        + ([u_thrust, *u_torque] if back_calc else [])
    )
    zero_row = torch.zeros_like(fcount)
    out = torch.stack(rows + [zero_row] * (ROWS - len(rows)))
    acc_out = torch.stack([min_dist, track_sum, min_alt, min_clear] + [zero_row] * 4)
    return out, acc_out


def _check_rows(name: str, x: torch.Tensor, rows: int, B: int, device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, state_rows on {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the CUDA tick block takes float32, {name} is {x.dtype}")
    if tuple(x.shape) != (rows, B):
        raise ValueError(f"{name} must be ({rows}, {B}), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def run_tick_block(
    control_cfg, physics_cfg, control_dt: float, T: int, substeps: int,
    state_rows: torch.Tensor, sp_pos: torch.Tensor, sp_vel: torch.Tensor,
    sp_acc: torch.Tensor, goal_wind: torch.Tensor,
    obstacle_rows: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run one tick block; returns ``(state_rows (32, B), accum_rows (8,
    B))``. Inactive obstacle rows must carry r = -1e30. Under
    back-calculation the state rows carry the unsaturated thrust and torque
    (:func:`pack_state` with ``back_calc=True``).

    On CUDA tensors it launches the kernel on the current stream (no
    synchronization), once per :func:`tick_chunks` entry, or raises; on CPU
    tensors it runs :func:`run_tick_block_plain`."""
    from dart_planner_tpu_torch.common.metrics import span  # common shares ops' layer

    with span("b2.wrapper"):
        args = (control_cfg, physics_cfg, control_dt, T, substeps, state_rows, sp_pos,
                sp_vel, sp_acc, goal_wind, obstacle_rows)
        if state_rows.device.type != "cuda":
            return run_tick_block_plain(*args)
        return launch_tick_block(_library(), *args)


def launch_tick_block(
    lib: ctypes.CDLL, control_cfg, physics_cfg, control_dt: float, T: int,
    substeps: int, state_rows: torch.Tensor, sp_pos: torch.Tensor,
    sp_vel: torch.Tensor, sp_acc: torch.Tensor, goal_wind: torch.Tensor,
    obstacle_rows: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA arm of :func:`run_tick_block` on ``lib``, a library bound by
    :func:`bind`: :func:`run_library` on the current stream of the rows'
    card, with that card current. Raises on anything it does not take."""
    device = state_rows.device
    if device.type != "cuda":
        raise ValueError(f"the CUDA tick block takes CUDA tensors, got {device}")
    # launched with the tensors' card current (see ops/cuda_mpc.py)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        return run_library(lib, control_cfg, physics_cfg, control_dt, T, substeps,
                           state_rows, sp_pos, sp_vel, sp_acc, goal_wind, obstacle_rows,
                           stream)


def run_library(
    lib: ctypes.CDLL, control_cfg, physics_cfg, control_dt: float, T: int,
    substeps: int, state_rows: torch.Tensor, sp_pos: torch.Tensor,
    sp_vel: torch.Tensor, sp_acc: torch.Tensor, goal_wind: torch.Tensor,
    obstacle_rows: torch.Tensor | None, stream,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The launches of one tick block through ``lib`` (a library with the C
    interface of ``csrc/tick_block.cu``) on ``stream``: checks the rows,
    then launches once per entry of :func:`tick_chunks` (nothing for B =
    0), each launch on the state the last one wrote and its own slice of the
    setpoint rows, the metrics combined by :func:`combine_metrics`. Raises
    if a launch fails. A launch on a CUDA stream adds one to ``LAUNCHES``;
    ``stream=None`` (a library built for the CPU) does not."""
    global LAUNCHES
    device = state_rows.device
    if T < 1 or substeps < 1:
        raise ValueError(f"T and substeps must be >= 1, got {T}, {substeps}")
    B = state_rows.shape[1]
    _check_rows("state_rows", state_rows, ROWS, B, device)
    for name, x in (("sp_pos", sp_pos), ("sp_vel", sp_vel), ("sp_acc", sp_acc)):
        _check_rows(name, x, 3 * T, B, device)
    _check_rows("goal_wind", goal_wind, ACC_ROWS, B, device)
    K = 0
    if obstacle_rows is not None:
        if obstacle_rows.shape[0] % 4:
            raise ValueError(
                f"obstacle_rows must have 4K rows, got {obstacle_rows.shape[0]}"
            )
        K = obstacle_rows.shape[0] // 4
        _check_rows("obstacle_rows", obstacle_rows, 4 * K, B, device)

    out = state_rows
    acc, t0 = None, 0
    for n in tick_chunks(T, device):
        state = out
        out = torch.empty((ROWS, B), dtype=torch.float32, device=device)
        more = torch.empty((ACC_ROWS, B), dtype=torch.float32, device=device)
        if B > 0:
            params = _launch_params(control_cfg, physics_cfg, control_dt, n, substeps, B, K)
            r = 4 * 3 * t0 * B  # the byte offset of the launch's first setpoint row
            err = lib.tick_block_launch(
                ctypes.byref(params), state.data_ptr(), sp_pos.data_ptr() + r,
                sp_vel.data_ptr() + r, sp_acc.data_ptr() + r, goal_wind.data_ptr(),
                None if K == 0 else obstacle_rows.data_ptr(), out.data_ptr(),
                more.data_ptr(), stream,
            )
            if err != 0:
                raise RuntimeError(
                    f"tick_block launch failed: CUDA error {err} "
                    f"({lib.tick_error_string(err).decode()})"
                )
            if stream is not None:
                LAUNCHES += 1
        acc = more if acc is None else combine_metrics(acc, more)
        t0 += n
    return out, acc
