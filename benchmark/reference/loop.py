"""Plain PyTorch reference of one replan of the closed loop: the problem the
planner is handed at a replan (the margins, the goal-clamped endgame set,
in-flight sensing, the unknown-space speed cap, sensor noise, the warm
start), the per-tick setpoints interpolated from a plan, the 400 Hz tick
block of the geometric controller and the rigid-body plant, and an
episode's outcome from its blocks' metrics.

Written from the port's ``sim/closed_loop.py`` and the plain version of
its tick block (``ops/cuda_rollout.py``), against this file's own inputs;
it imports nothing of the program, of JAX or of the JAX package. The
state rows of a tick block are the layout the program hands between its
blocks (rows 0-2 position, 3-5 velocity, 6-8 body rates, 9-17 the
rotation row-major, 18-20 the integral, 21-23 the torque saturation, 24
the failsafe count, 25 the last valid thrust, 26-29 the unsaturated
thrust and torque under back-calculation); the reference reads them only
to follow the program from block to block. Every product of two rotations
and the setpoint interpolation go through ``solve.matmul``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import solve
from benchmark.reference.solve import Problem, SolverConfig, margins

Tensor = torch.Tensor
ROWS = 32
BACK_CALC_SPLIT = (0.33, 0.33, 0.34)
INACTIVE_RADIUS = -1e30


def unit_linspace(num: int, dtype, device) -> Tensor:
    t = torch.arange(num - 1, dtype=dtype, device=device) * (1.0 / (num - 1))
    return torch.cat([t, torch.ones(1, dtype=dtype, device=device)])


class Glue:
    """What the loop derives once an episode from its inputs: the planner's
    sphere sets with full and with goal-clamped margins, the corridor's
    samples and which are unknown."""

    def __init__(self, loop: dict, mpc: SolverConfig, inp: dict):
        self.loop, self.mpc = loop, mpc
        self.goal = inp["goals"]
        self.true_obs, self.true_mask = inp["true_obstacles"], inp["true_mask"]
        self.mask = inp["mask"]
        self.noise = inp["noise"]

        def plan_set(clamped: bool):
            cfg = mpc if clamped else mpc._replace(goal_margin_clamp=0.0)
            sets = []
            for obs, mask in ((inp["obstacles"], inp["mask"]),
                              (self.true_obs, self.true_mask)):
                out = obs.clone()
                out[..., 3] += torch.where(mask, margins(cfg, obs, self.goal), 0.0)
                sets.append(out)
            return torch.cat(sets, dim=-2)

        self.plan = plan_set(False)
        self.plan_clamped = plan_set(True)
        cov = inp["corridor"]
        t = unit_linspace(cov.shape[-1], cov.dtype, cov.device)
        p0 = inp["starts"]
        self.corr_pts = p0[..., None, :] + t[:, None] * (self.goal - p0)[..., None, :]
        self.corr_unknown = cov < loop["unknown_coverage"]

    def problem(self, block: int, p_now: Tensor, v_now: Tensor, rows=None) -> Problem:
        """The problem of replan ``block`` from the vehicles' true position
        and velocity, for the episodes ``rows`` (all when None)."""
        lp, mpc = self.loop, self.mpc

        def take(x):
            return x if rows is None else x[rows]

        goal = take(self.goal)
        d = torch.linalg.vector_norm(p_now[..., None, :] - take(self.corr_pts), dim=-1)
        d_unk = torch.where(take(self.corr_unknown), d, math.inf).amin(-1)
        ramp = torch.clamp((d_unk - lp["unknown_margin"]) / lp["unknown_ramp"], 0.0, 1.0)
        v_cap = (lp["unknown_speed_cap"]
                 + (mpc.max_velocity - lp["unknown_speed_cap"]) * ramp)
        near = torch.linalg.vector_norm(p_now - goal, dim=-1) < lp["goal_clamp_radius"]
        obs = torch.where(near[..., None, None], take(self.plan_clamped), take(self.plan))
        tobs = take(self.true_obs)
        gap = torch.linalg.vector_norm(p_now[..., None, :] - tobs[..., :3], dim=-1) - tobs[..., 3]
        sensed = take(self.true_mask) & (gap <= lp["sense_radius"])
        mask = torch.cat([take(self.mask), sensed], dim=-1)
        noise = take(self.noise[block])
        return Problem(p_now + noise[..., :3], v_now + noise[..., 3:], goal, obs, mask, v_cap)

    def goal_wind(self, wind: Tensor) -> Tensor:
        """The tick block's goal and wind rows (8, B)."""
        B = self.goal.shape[0]
        z = torch.zeros((2, B), dtype=wind.dtype, device=wind.device)
        return torch.cat([self.goal.T, wind.T, z], dim=0).contiguous()

    def sphere_rows(self) -> Tensor:
        """The true spheres as (4K, B) rows, an inactive one with r = -1e30."""
        r = torch.where(self.true_mask, self.true_obs[..., 3], INACTIVE_RADIUS)
        rows = torch.cat([self.true_obs[..., :3], r[..., None]], dim=-1)
        B, K = rows.shape[0], rows.shape[1]
        return rows.reshape(B, 4 * K).T.contiguous()


def lerp_matrix(T: int, control_dt: float, mpc_dt: float, N: int) -> np.ndarray:
    """(T, N) weights of the plan's linear interpolation at each tick."""
    W = np.zeros((T, N), np.float32)
    for j in range(T):
        x = min(max((j + 1) * control_dt / mpc_dt, 0.0), N - 1.001)
        i0 = int(np.floor(x))
        W[j, i0] = 1.0 - (x - i0)
        W[j, i0 + 1] += x - i0
    return W


def setpoints(T: int, control_dt: float, mpc_dt: float, *plans: Tensor) -> list:
    """Plan arrays (B, N, 3) -> setpoint rows (3T, B): row 3t+d is axis d
    at tick t."""
    out = []
    for arr in plans:
        W = torch.as_tensor(lerp_matrix(T, control_dt, mpc_dt, arr.shape[-2]),
                            dtype=arr.dtype, device=arr.device)
        out.append(solve.matmul(W, arr).reshape(arr.shape[0], 3 * T).T.contiguous())
    return out


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _norm(a: Tensor) -> Tensor:
    return torch.sqrt(_dot(a, a))


def _cross(a: Tensor, b: Tensor) -> Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _vec(v, like: Tensor) -> Tensor:
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def tick_block(ctrl: dict, plant: dict, control_dt: float, T: int, substeps: int,
               S: Tensor, spp: Tensor, spv: Tensor, spa: Tensor, gw: Tensor,
               obs: Tensor):
    """``T`` ticks of the geometric controller and the rigid-body plant over
    state rows ``S`` (32, B): the new rows and the metric rows (8, B): min
    goal distance, summed squared tracking error, min altitude, min sphere
    surface clearance. ``ctrl`` and ``plant`` are the configuration's
    controller and plant fields."""
    c, p = ctrl, plant
    back_calc = c["anti_windup_method"] != "clamping"
    ref_yaw = c["yaw_convention"] == "reference"
    like = S[0]
    kp, ki, kd = (_vec(c[k], like) for k in ("kp_pos", "ki_pos", "kd_pos"))
    kp_att, kd_att = _vec(c["kp_att"], like), _vec(c["kd_att"], like)
    inertia, max_tq = _vec(c["inertia"], like), _vec(c["max_torque_xyz"], like)
    per_axis = _vec(c["max_integral_per_axis"], like)
    near_int = per_axis * c["saturation_threshold"]
    p_inertia = _vec(p["inertia"], like)
    mass, g = float(c["mass"]), float(c["gravity"])
    min_thrust = float(c["min_thrust"]) * mass * g
    max_thrust = float(c["max_thrust"])
    cos_max, sin_max = float(np.cos(c["max_tilt_angle"])), float(np.sin(c["max_tilt_angle"]))
    h = control_dt / substeps
    split = _vec(BACK_CALC_SPLIT, like)
    e1 = _vec((1.0, 0.0, 0.0), like)
    eye = torch.eye(3, dtype=like.dtype, device=like.device)

    pos, vel, omega = S[0:3].T, S[3:6].T, S[6:9].T
    R = S[9:18].T.reshape(-1, 3, 3)
    integral, lt_sat = S[18:21].T, S[21:24].T
    fcount, last_valid = S[24], S[25]
    u_thrust, u_torque = S[26], S[27:30].T
    goal, wind = gw[0:3].T, gw[3:6].T
    K = obs.shape[0] // 4
    big = torch.full_like(fcount, 1e30)
    min_dist, min_alt, min_clear = big, big, big
    track = torch.zeros_like(fcount)

    for j in range(T):
        sp_p, sp_v, sp_a = spp[3 * j:3 * j + 3].T, spv[3 * j:3 * j + 3].T, spa[3 * j:3 * j + 3].T
        pe, ve = sp_p - pos, sp_v - vel
        pe_mag, ve_mag = _norm(pe), _norm(ve)
        f = sp_a + kp * pe + kd * ve + ki * integral
        f = torch.stack([f[:, 0], f[:, 1], f[:, 2] + g], dim=-1)
        f_norm = _norm(f)
        thrust_raw = mass * f_norm
        thrust_mag = torch.clamp(thrust_raw, min_thrust, max_thrust)
        thrust_sat = (thrust_raw != thrust_mag).to(like.dtype)

        if back_calc:
            thrust_fb = torch.where(thrust_sat > 0.5, (u_thrust - max_thrust) * c[
                "back_calculation_gain"], torch.zeros_like(u_thrust))
            torque_fb = torch.where(lt_sat > 0.5, (u_torque - max_tq) * c[
                "back_calculation_gain"], torch.zeros_like(u_torque))
            v = integral + (ve * control_dt - thrust_fb[:, None] * split - torque_fb * 0.5)
        else:
            damp = (1.0 - 0.9 * thrust_sat)[:, None] * (1.0 - 0.9 * lt_sat)
            v = integral + ve * control_dt * damp
        v = torch.maximum(torch.minimum(v, per_axis), -per_axis)
        mag = _norm(v)
        scale = torch.where(mag > c["max_integral_pos"],
                            c["max_integral_pos"] / torch.clamp(mag, min=1e-9),
                            torch.ones_like(mag))
        v = v * scale[:, None]
        integral = torch.where(v.abs() > near_int, v * c["integral_decay_factor"], v)

        b3 = f * (1.0 / torch.clamp(f_norm, min=1e-9))[:, None]
        tm_ok = (thrust_mag > 1e-6).to(like.dtype)
        b3 = torch.stack([b3[:, 0] * tm_ok, b3[:, 1] * tm_ok, b3[:, 2] * tm_ok + (1.0 - tm_ok)],
                         dim=-1)
        over = b3[:, 2] < cos_max
        inv_xy = 1.0 / torch.clamp(torch.sqrt(b3[:, 0] * b3[:, 0] + b3[:, 1] * b3[:, 1]),
                                   min=1e-9)
        b3 = torch.stack([torch.where(over, sin_max * b3[:, 0] * inv_xy, b3[:, 0]),
                          torch.where(over, sin_max * b3[:, 1] * inv_xy, b3[:, 1]),
                          torch.where(over, cos_max + 0.0 * b3[:, 2], b3[:, 2])], dim=-1)
        singular = b3[:, 0].abs() >= c["yaw_singularity_threshold"]
        ex = e1.expand_as(b3)
        b1_raw = _cross(ex, b3) if ref_yaw else _cross(_cross(b3, ex), b3)
        n1 = _norm(b1_raw)
        ok = n1 > 1e-6
        b1_normal = torch.where(ok[:, None], b1_raw * (1.0 / torch.where(
            ok, n1, torch.ones_like(n1)))[:, None], ex)
        straight = b3[:, 2].abs() >= 0.99
        proj = torch.stack([1.0 - b3[:, 0] * b3[:, 0], -b3[:, 0] * b3[:, 1],
                            -b3[:, 0] * b3[:, 2]], dim=-1)
        npj = _norm(proj)
        ok_p = npj > 1e-9
        b1_skip = torch.where(straight[:, None], ex, torch.where(ok_p[:, None], proj * (
            1.0 / torch.where(ok_p, npj, torch.ones_like(npj)))[:, None], ex))
        b1 = torch.where(singular[:, None], b1_skip, b1_normal)
        Rd = torch.stack([b1, _cross(b3, b1), b3], dim=-1)
        M = solve.matmul(Rd.transpose(-1, -2), R)
        eR = 0.5 * torch.stack([M[:, 2, 1] - M[:, 1, 2], M[:, 0, 2] - M[:, 2, 0],
                                M[:, 1, 0] - M[:, 0, 1]], dim=-1)
        tq_raw = -kp_att * eR - kd_att * omega + _cross(omega, inertia * omega)
        tq = torch.maximum(torch.minimum(tq_raw, max_tq), -max_tq)
        lt_sat = (tq_raw != tq).to(like.dtype)
        if back_calc:
            u_thrust, u_torque = thrust_raw, tq_raw

        bad = (pe_mag > c["tracking_error_threshold"]) & (ve_mag > c["velocity_error_threshold"])
        fcount = torch.where(bad, fcount + 1.0, torch.clamp(fcount - 1.0, min=0.0))
        fs = fcount > c["failsafe_trigger_count"]
        thrust_out = torch.where(fs, last_valid, thrust_mag)
        tq = torch.where(fs[:, None], 0.0, tq)
        integral = torch.where(fs[:, None], 0.0, integral)
        last_valid = torch.where(fs, last_valid, thrust_mag)

        thr = torch.clamp(thrust_out, 0.0, p["max_thrust"])
        ptq = torch.clamp(tq, -p["max_torque"], p["max_torque"])
        for _ in range(substeps):
            acc = R[:, :, 2] * thr[:, None] / p["mass"]
            acc = acc - _vec((0.0, 0.0, p["gravity"]), like)
            acc = acc + wind / p["mass"]
            if p["drag_coefficient"] > 0:
                acc = acc - p["drag_coefficient"] * vel
            vel = vel + acc * h
            pos = pos + vel * h
            omega = omega + (ptq - _cross(omega, p_inertia * omega)) / p_inertia * h
            w = omega * h
            t2 = _dot(w, w)
            theta = torch.sqrt(t2)
            small = theta < 1e-5
            one = torch.ones_like(theta)
            a_c = torch.where(small, 1.0 - t2 / 6.0, torch.sin(theta) / torch.where(
                small, one, theta))
            b_c = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(theta)) / torch.where(
                small, one, t2))
            wx, wy, wz = w[:, 0], w[:, 1], w[:, 2]
            E = torch.stack([
                torch.stack([1.0 + b_c * (-(wy * wy + wz * wz)), -a_c * wz + b_c * wx * wy,
                             a_c * wy + b_c * wx * wz], -1),
                torch.stack([a_c * wz + b_c * wx * wy, 1.0 + b_c * (-(wx * wx + wz * wz)),
                             -a_c * wx + b_c * wy * wz], -1),
                torch.stack([-a_c * wy + b_c * wx * wz, a_c * wx + b_c * wy * wz,
                             1.0 + b_c * (-(wx * wx + wy * wy))], -1)], dim=-2)
            R = solve.matmul(R, E)

        min_dist = torch.minimum(min_dist, _norm(pos - goal))
        min_alt = torch.minimum(min_alt, pos[:, 2])
        te = pos - sp_p
        track = track + _dot(te, te)
        for k in range(K):
            o = obs[4 * k:4 * k + 3].T
            min_clear = torch.minimum(min_clear, _norm(pos - o) - obs[4 * k + 3])

    rows = [pos.T, vel.T, omega.T, R.reshape(-1, 9).T, integral.T, lt_sat.T,
            fcount[None], last_valid[None]]
    if back_calc:
        rows += [u_thrust[None], u_torque.T]
    out = torch.cat(rows, dim=0)
    out = torch.cat([out, torch.zeros((ROWS - out.shape[0], out.shape[1]), dtype=out.dtype,
                                      device=out.device)], dim=0)
    zero = torch.zeros_like(fcount)
    return out, torch.stack([min_dist, track, min_alt, min_clear, zero, zero, zero, zero])


def initial_rows(starts: Tensor, ctrl: dict) -> Tensor:
    """The state rows of vehicles at rest at ``starts``, level, with the
    controller's initial state (the last valid thrust is hover's)."""
    B = starts.shape[0]
    z = torch.zeros((B,), dtype=starts.dtype, device=starts.device)
    rows = [starts.T, torch.zeros((6, B), dtype=starts.dtype, device=starts.device),
            torch.eye(3, dtype=starts.dtype, device=starts.device).reshape(9, 1).expand(9, B),
            torch.zeros((7, B), dtype=starts.dtype, device=starts.device),
            (z + float(ctrl["mass"]) * float(ctrl["gravity"]))[None]]
    out = torch.cat(rows, dim=0)
    return torch.cat([out, torch.zeros((ROWS - out.shape[0], B), dtype=out.dtype,
                                       device=out.device)], dim=0)


def outcome(loop: dict, metrics: Tensor, final_pos: Tensor, goal: Tensor) -> dict:
    """An episode's outcome from its blocks' metric rows (replans, 4, B) and
    its final position."""
    final_dist = torch.linalg.vector_norm(final_pos - goal, dim=-1)
    n = metrics.shape[0] * int(loop["substeps_per_plan"])
    min_clear = metrics[:, 3].amin(0)
    crashed = (metrics[:, 2].amin(0) < loop["min_altitude"]) | (min_clear < 0.0)
    return {"final_position": final_pos, "final_distance": final_dist,
            "min_distance": torch.minimum(metrics[:, 0].amin(0), final_dist),
            "tracking_rmse": torch.sqrt(metrics[:, 1].sum(0) / n),
            "min_obstacle_clearance": min_clear, "crashed": crashed,
            "success": (final_dist < loop["goal_tolerance"]) & ~crashed}
