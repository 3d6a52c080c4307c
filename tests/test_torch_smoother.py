"""The port's trajectory smoother (dart_planner_tpu_torch/control/smoother.py)
against the JAX package on the same numpy inputs.

The six cases of tests/test_smoother.py, each run through both packages on
the same trajectories and times, the port's smoother configured by
``interop.smoother_config_from_jax_fields`` (the JAX package's order of
rate limits and smoothing): every command (pos, vel, acc) and every state
field the case reaches is compared at atol 1e-5 (float32 arithmetic in the
same order; the largest difference seen is ~2e-6 m), flags exactly, and
each case keeps its own behavioural assertions on the port. The vmapped
JAX smoother is held element by element against one batched call of the
port. The JAX package's state is carried across with
``interop.smoother_state_from_numpy`` where a case starts mid-flight.

Then the port's default order (limits on the smoothed command): equal to
the JAX package's wherever no limit is active, and the same acceleration
slew at 100 Hz and 400 Hz where the JAX order's slews 4x slower at 400 Hz
(tests/test_torch_smoother_cadence.py flies both orders at the
deployment's cadence).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dart_planner_tpu.common.types import DroneState as JDroneState
from dart_planner_tpu.common.types import Trajectory as JTrajectory
from dart_planner_tpu.control import smoother as J
from dart_planner_tpu_torch import DroneState, Trajectory
from dart_planner_tpu_torch import interop
from dart_planner_tpu_torch.control import smoother as T

ATOL = 1e-5
FIELDS = ("positions", "velocities", "accelerations", "timestamps", "traj_start_time",
          "last_update_time", "has_trajectory", "in_transition", "transition_start_time",
          "trans_p0", "trans_v0", "trans_p1", "trans_v1", "last_pos", "last_vel",
          "last_acc", "last_call_time", "primed")


def _line(p0, p1, t0=0.0, N=20, dt=0.1):
    """numpy (timestamps, positions, velocities, accelerations), float32."""
    ts = t0 + dt * np.arange(N)
    alpha = np.linspace(0, 1, N)[:, None]
    pos = (1 - alpha) * np.asarray(p0) + alpha * np.asarray(p1)
    vel = np.broadcast_to((np.asarray(p1) - np.asarray(p0)) / ((N - 1) * dt), (N, 3))
    return tuple(np.array(x, np.float32) for x in (ts, pos, vel, np.zeros((N, 3))))


def _jtraj(arrs):
    return JTrajectory(*[jnp.asarray(x) for x in arrs])


def _ttraj(arrs):
    return Trajectory(*[torch.tensor(x) for x in arrs])


def _drones(position=(0.0, 0.0, 0.0)):
    return (JDroneState.create(position=position),
            DroneState.create(position=position, device="cpu"))


def _close(j, t, what):
    np.testing.assert_allclose(t.numpy(), np.asarray(j, np.float32), atol=ATOL,
                               rtol=0, err_msg=what)


def _same_state(js, ts):
    for name in FIELDS:
        j, t = np.asarray(getattr(js, name)), getattr(ts, name)
        if j.dtype == np.bool_:
            np.testing.assert_array_equal(t.numpy(), j, err_msg=name)
        else:
            _close(j, t, name)


class _Pair:
    """One smoother in each package, fed the same calls."""

    def __init__(self, cfg=None, horizon=20):
        self.jcfg = cfg or J.SmootherConfig()
        self.tcfg = interop.smoother_config_from_jax_fields(self.jcfg)
        self.js = J.SmootherState.zeros(horizon)
        self.ts = T.SmootherState.zeros(horizon, device="cpu")

    def update(self, arrs, t):
        self.js = J.update_trajectory(self.jcfg, self.js, _jtraj(arrs), jnp.float32(t))
        self.ts = T.update_trajectory(self.tcfg, self.ts, _ttraj(arrs), t)
        _same_state(self.js, self.ts)

    def desired(self, t, drones):
        (jp, jv, ja), self.js = J.get_desired_state(self.jcfg, self.js, jnp.float32(t),
                                                    drones[0])
        (tp, tv, ta), self.ts = T.get_desired_state(self.tcfg, self.ts, t, drones[1])
        for name, j, x in (("pos", jp, tp), ("vel", jv, tv), ("acc", ja, ta)):
            _close(j, x, f"{name} at t={t}")
        _same_state(self.js, self.ts)
        return tp, tv, ta


def test_failsafe_hold_without_plan():
    jsm = J.TrajectorySmoother()
    tsm = T.TrajectorySmoother(config=interop.smoother_config_from_jax_fields(jsm.config),
                               device="cpu")
    jd, td = _drones((1.0, 2.0, 3.0))
    jp, jv, _ = jsm.get_desired_state(0.0, jd)
    pos, vel, acc = tsm.get_desired_state(0.0, td)
    _close(jp, pos, "pos")
    _close(jv, vel, "vel")
    np.testing.assert_allclose(pos.numpy(), [1, 2, 3], atol=1e-6)
    np.testing.assert_allclose(vel.numpy(), 0, atol=1e-6)


def test_follows_trajectory():
    pair = _Pair()
    drones = _drones()
    pair.update(_line([0, 0, 0], [10, 0, 0]), 0.0)
    # drive at the 100 Hz rate the rate limiters assume
    for t in np.arange(0.0, 0.95, 0.01):
        pos_mid, vel_mid, _ = pair.desired(float(t), drones)
    assert 3.0 < float(pos_mid[0]) < 6.0
    assert 1.5 < float(vel_mid[0]) < 6.0


def test_interpolation_clamps_at_end():
    pair = _Pair()
    drones = _drones()
    pair.update(_line([0, 0, 0], [10, 0, 0]), 0.0)
    for t in np.arange(0.0, 1.9, 0.01):
        pair.desired(float(t), drones)  # prime smoothing along the way
    pos, _, _ = pair.desired(5.0, drones)  # past the plan's end and the failsafe
    np.testing.assert_allclose(pos.numpy(), drones[1].position.numpy(), atol=1e-5)


def test_jump_starts_min_jerk_transition():
    pair = _Pair()
    drones = _drones()
    pair.update(_line([0, 0, 0], [0, 0, 0]), 0.0)  # hover at origin
    pair.desired(0.1, drones)
    # new plan starts 2 m away -> jump
    pair.update(_line([2, 0, 0], [5, 0, 0], t0=0.1), 0.1)
    assert bool(pair.ts.in_transition)
    xs = []
    for t in np.arange(0.1, 0.1 + pair.tcfg.transition_time, 0.05):
        pos, _, _ = pair.desired(float(t), drones)
        xs.append(float(pos[0]))
    assert xs[0] < 0.5  # starts near the old command
    assert all(b >= a - 1e-4 for a, b in zip(xs, xs[1:]))  # monotone blend
    pair.desired(0.1 + pair.tcfg.transition_time + 0.05, drones)
    assert not bool(pair.ts.in_transition)


def test_no_jump_no_transition():
    pair = _Pair()
    drones = _drones()
    pair.update(_line([0, 0, 0], [10, 0, 0]), 0.0)
    pair.desired(0.1, drones)
    # replan from nearly the same state -> no transition; the port starts
    # from the JAX package's state carried across
    js = pair.js
    pair.ts = interop.smoother_state_from_numpy(
        {name: np.asarray(getattr(js, name)) for name in FIELDS})
    pair.update(_line([0.55, 0, 0], [10, 0, 0], t0=0.1), 0.1)
    assert not bool(pair.ts.in_transition)


def test_vmapped_smoothers():
    """JAX vmaps one smoother over B; the port takes the (B, ...) state in
    one call. Four vehicles with their own plans, times and positions."""
    jcfg = J.SmootherConfig()
    tcfg = interop.smoother_config_from_jax_fields(jcfg)
    B, N = 4, 20
    rng = np.random.default_rng(0)
    plans = [_line(rng.normal(0, 1, 3), rng.normal(5, 2, 3), t0=0.1 * i) for i in range(B)]
    stacked = tuple(np.stack([p[k] for p in plans]) for k in range(4))
    t_up = np.float32([0.0, 0.1, 0.2, 0.3])
    pos_d = rng.normal(0, 1, (B, 3)).astype(np.float32)

    js = J.SmootherState.zeros(N, (B,))
    js = jax.vmap(lambda s, tr, tt: J.update_trajectory(jcfg, s, tr, tt))(
        js, _jtraj(stacked), jnp.asarray(t_up))
    ts = T.SmootherState.zeros(N, (B,), device="cpu")
    ts = T.update_trajectory(tcfg, ts, _ttraj(stacked), torch.tensor(t_up))
    _same_state(js, ts)

    jd = JDroneState.zeros((B,)).replace(position=jnp.asarray(pos_d))
    td = DroneState.zeros((B,), device="cpu").replace(position=torch.tensor(pos_d))
    for t in (0.5, 0.51, 0.6, 3.0):  # the last call is stale: failsafe hold
        tt = np.full(B, t, np.float32)
        (jp, jv, ja), js = jax.vmap(lambda s, x, d: J.get_desired_state(jcfg, s, x, d))(
            js, jnp.asarray(tt), jd)
        (tp, tv, ta), ts = T.get_desired_state(tcfg, ts, torch.tensor(tt), td)
        assert tp.shape == (B, 3)
        for name, j, x in (("pos", jp, tp), ("vel", jv, tv), ("acc", ja, ta)):
            _close(j, x, f"{name} at t={t}")
        _same_state(js, ts)
    np.testing.assert_allclose(tp.numpy(), pos_d, atol=1e-6)


def _slew(cfg, dt, seconds=0.3):
    """The acceleration command over ``seconds`` of ticks of ``dt`` after a plan
    that asks for 10 m/s^2 along x from rest."""
    N = 20
    ts = np.float32(0.1) * np.arange(N, dtype=np.float32)
    acc = np.zeros((N, 3), np.float32)
    acc[:, 0] = 10.0
    st = T.SmootherState.zeros(N, device="cpu")
    st = T.update_trajectory(cfg, st, _ttraj((ts, np.zeros((N, 3), np.float32),
                                              np.zeros((N, 3), np.float32), acc)), 0.0)
    d = DroneState.create(device="cpu")
    out = []
    for k in range(int(round(seconds / dt)) + 1):
        (_, _, a), st = T.get_desired_state(cfg, st, k * dt, d)
        out.append(float(a[0]))
    return np.array(out)


def test_default_order_equals_jax_where_no_limit_acts():
    """A gentle plan (0.5 m/s^2 at 100 Hz): no limit is ever active, so the
    two orders and the JAX package give the same commands (atol 1e-5)."""
    N = 20
    ts = np.float32(0.1) * np.arange(N, dtype=np.float32)
    acc = np.full((N, 3), 0.05, np.float32)
    vel = (ts[:, None] * acc).astype(np.float32)
    pos = (0.5 * ts[:, None] ** 2 * acc).astype(np.float32)
    plan = (ts, pos, vel, acc)
    pair = _Pair()
    pair.update(plan, 0.0)
    ours = T.update_trajectory(T.SmootherConfig(), T.SmootherState.zeros(N, device="cpu"),
                               _ttraj(plan), 0.0)
    drones = _drones()
    for k in range(60):
        t = 0.01 * k
        jp, jv, ja = pair.desired(t, drones)
        (p, v, a), ours = T.get_desired_state(T.SmootherConfig(), ours, t, drones[1])
        for j, x in ((jp, p), (jv, v), (ja, a)):
            np.testing.assert_allclose(x.numpy(), j.numpy(), atol=1e-5, rtol=0)


def test_default_order_slews_at_the_same_rate_at_any_loop_rate():
    """10 m/s^2 asked for from rest: after 0.3 s the default order's command
    is the same at 100 Hz and 400 Hz (within 2%: the filter's discrete
    steps); the JAX order's slews at 6 m/s^3 at 100 Hz and 1.5 m/s^3 at
    400 Hz from 0.1 s to 0.3 s (its limit times alpha: ~dt^2 a tick), after
    the same 0.6 m/s^2 first step (unprimed: limit only). The port with the
    JAX order is the JAX package's smoother (the cases above)."""
    ours = T.SmootherConfig()
    theirs = ours._replace(rate_limits="before_smoothing")
    a100, a400 = _slew(ours, 0.01)[-1], _slew(ours, 0.0025)[-1]
    assert a400 == pytest.approx(a100, rel=0.02), (a100, a400)
    assert a100 > 9.0  # reaches the plan's 10 m/s^2 within 0.3 s
    j100, j400 = _slew(theirs, 0.01), _slew(theirs, 0.0025)
    assert j100[0] == pytest.approx(0.6) and j400[0] == pytest.approx(0.6)
    slew100 = (j100[-1] - j100[10]) / 0.2
    slew400 = (j400[-1] - j400[40]) / 0.2
    assert slew100 == pytest.approx(6.0, rel=0.01), slew100
    assert slew400 == pytest.approx(1.5, rel=0.01), slew400
