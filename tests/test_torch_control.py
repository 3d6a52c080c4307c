"""The port's geometric SE(3) controller (dart_planner_tpu_torch/control/)
against the JAX package on the same numpy inputs.

Every scenario feeds both packages one batch of states, setpoints and
controller states made from a seed with numpy, and compares the command
and the new controller state: floats at atol 1e-5 (rtol 1e-6 for the
unsaturated thrust, which reaches ~100 N), flags and counts exactly.
Each scenario checks that it reached the branch it names.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dart_planner_tpu.common.types import DroneState as JDroneState
from dart_planner_tpu.control import geometric as J
from dart_planner_tpu_torch import DroneState
from dart_planner_tpu_torch.control import geometric as T

B = 8
DT = 0.0025


def _configs(method, convention, **kw):
    fields = dict(mass=1.5, max_thrust=25.0, anti_windup_method=method,
                  yaw_convention=convention, failsafe_trigger_count=5, **kw)
    return J.GeometricConfig(**fields), T.GeometricConfig(**fields)


def _f32(rng, *shape, scale=1.0, loc=0.0):
    return (loc + scale * rng.standard_normal(shape)).astype(np.float32)


def _scenario(name, seed):
    """numpy inputs: drone state, setpoint, controller state and dt."""
    rng = np.random.default_rng(seed)
    pos = _f32(rng, B, 3, loc=0.0) + np.float32([0, 0, 4])
    sp_pos = pos + _f32(rng, B, 3, scale=0.3)
    vel = _f32(rng, B, 3, scale=0.3)
    sp_vel = _f32(rng, B, 3, scale=0.3)
    sp_acc = _f32(rng, B, 3, scale=0.5)
    att = _f32(rng, B, 3, scale=0.2)
    omega = _f32(rng, B, 3, scale=0.5)
    yaw = _f32(rng, B, scale=0.3)
    count = rng.integers(0, 4, B).astype(np.int32)
    dt = DT
    if name == "hover":
        sp_pos, vel, sp_vel, sp_acc = pos.copy(), 0 * vel, 0 * vel, 0 * sp_acc
        att, omega, yaw = 0 * att, 0 * omega, 0 * yaw
    elif name == "tilt_limited":
        sp_pos = pos + np.float32([6.0, -4.0, 0.0])  # large lateral demand
    elif name == "yaw_singular_straight_up":
        # |b3_xy| ~ 0.12 along c: singular (|c . b3| >= 0.1) and |b3_z| >= 0.99
        sp_pos, vel, sp_vel, sp_acc = pos.copy(), 0 * vel, 0 * vel, 0 * sp_acc
        sp_acc[:, 0] = 1.18 * np.cos(yaw)
        sp_acc[:, 1] = 1.18 * np.sin(yaw)
    elif name == "thrust_saturation":
        sp_acc[: B // 2, 2] = 30.0  # above max thrust
        low = slice(B // 2, B)  # below min thrust: near free fall, on track
        sp_pos[low], sp_vel[low] = pos[low], vel[low]
        sp_acc[low] = np.float32([0.0, 0.0, -9.5])
    elif name == "failsafe":
        sp_pos = pos + np.float32([3.0, 0.0, 0.0])  # bad tracking
        sp_vel = vel + np.float32([2.0, 0.0, 0.0])
        count[:] = 5  # crosses the trigger this tick
        count[: B // 2] = 1
    elif name == "dt_invalid":
        dt = 0.0
    return dict(pos=pos, vel=vel, att=att, omega=omega, sp_pos=sp_pos,
                sp_vel=sp_vel, sp_acc=sp_acc, yaw=yaw, count=count, dt=dt,
                integral=_f32(rng, B, 3, scale=0.8),
                lt_sat=rng.integers(0, 2, (B, 3)).astype(bool),
                uns_thrust=_f32(rng, B, loc=20.0, scale=5.0),
                uns_torque=_f32(rng, B, 3, scale=3.0),
                last_valid=_f32(rng, B, loc=14.0))


def _jax_inputs(cfg, d):
    a = {k: jnp.asarray(v) for k, v in d.items() if k != "dt"}
    drone = JDroneState.create(timestamp=jnp.ones(B, jnp.float32), position=a["pos"],
                               velocity=a["vel"], attitude=a["att"],
                               angular_velocity=a["omega"])
    sp = J.ControlSetpoint(position=a["sp_pos"], velocity=a["sp_vel"],
                           acceleration=a["sp_acc"], yaw=a["yaw"],
                           yaw_rate=jnp.zeros(B, jnp.float32))
    st = J.ControllerState.zeros(cfg, (B,)).replace(
        integral_vel_error=a["integral"], last_torque_saturated=a["lt_sat"],
        unsaturated_thrust=a["uns_thrust"], unsaturated_torque=a["uns_torque"],
        failsafe_count=a["count"], last_valid_thrust=a["last_valid"],
    )
    return st, drone, sp


def _torch_inputs(cfg, d):
    a = {k: torch.tensor(v) for k, v in d.items() if k != "dt"}
    drone = DroneState(timestamp=torch.ones(B), position=a["pos"], velocity=a["vel"],
                       attitude=a["att"], angular_velocity=a["omega"])
    sp = T.ControlSetpoint(position=a["sp_pos"], velocity=a["sp_vel"],
                           acceleration=a["sp_acc"], yaw=a["yaw"],
                           yaw_rate=torch.zeros(B))
    st = T.ControllerState.zeros(cfg, (B,), device="cpu").replace(
        integral_vel_error=a["integral"], last_torque_saturated=a["lt_sat"],
        unsaturated_thrust=a["uns_thrust"], unsaturated_torque=a["uns_torque"],
        failsafe_count=a["count"], last_valid_thrust=a["last_valid"],
    )
    return st, drone, sp


def _assert_state_equal(js, ts):
    for name in ("integral_vel_error", "unsaturated_torque", "last_valid_thrust",
                 "last_time"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name), np.float32),
                                   atol=1e-5, err_msg=name)
    np.testing.assert_allclose(ts.unsaturated_thrust.numpy(),
                               np.asarray(js.unsaturated_thrust, np.float32),
                               atol=1e-5, rtol=1e-6)
    for name in ("last_thrust_saturated", "last_torque_saturated", "failsafe_count",
                 "failsafe_active"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), err_msg=name)


SCENARIOS = ("hover", "tilt_limited", "yaw_singular_straight_up",
             "thrust_saturation", "failsafe", "dt_invalid")


@pytest.mark.parametrize("convention", ["lee", "reference"])
@pytest.mark.parametrize("method", ["clamping", "back_calculation"])
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_compute_control_matches_jax(scenario, method, convention):
    jcfg, tcfg = _configs(method, convention)
    d = _scenario(scenario, SCENARIOS.index(scenario))
    jcmd, jst = J.compute_control(jcfg, *_jax_inputs(jcfg, d), d["dt"])
    tcmd, tst = T.compute_control(tcfg, *_torch_inputs(tcfg, d), d["dt"])
    np.testing.assert_allclose(tcmd.thrust.numpy(), np.asarray(jcmd.thrust, np.float32),
                               atol=1e-5)
    np.testing.assert_allclose(tcmd.torque.numpy(), np.asarray(jcmd.torque, np.float32),
                               atol=1e-5)
    _assert_state_equal(jst, tst)

    # the scenario reached its branch
    f = tst.unsaturated_thrust.numpy() / 1.5
    if scenario == "thrust_saturation":
        assert tst.last_thrust_saturated.all()
    if scenario == "failsafe":
        active = tst.failsafe_active.numpy()
        assert active[B // 2:].all() and not active[: B // 2].any()
        assert (tcmd.torque[B // 2:] == 0).all()
    if scenario == "dt_invalid":
        assert tst.failsafe_active.all()
    if scenario == "tilt_limited":
        # b3_des tilts past the 60 deg cone: the lateral share of the
        # demanded force (kp_xy = 7 on the position error) exceeds sin(60)
        lat = np.linalg.norm((d["sp_pos"] - d["pos"])[:, :2], axis=-1) * 7.0
        assert (lat > np.sin(np.pi / 3) * f).all()
    if scenario == "yaw_singular_straight_up":
        acc = d["sp_acc"]
        b3 = np.concatenate([acc[:, :2], acc[:, 2:] + 9.81], -1)
        b3 /= np.linalg.norm(b3, axis=-1, keepdims=True)
        c = np.stack([np.cos(d["yaw"]), np.sin(d["yaw"])], -1)
        assert (np.abs((c * b3[:, :2]).sum(-1)) >= 0.1).all()
        assert (np.abs(b3[:, 2]) >= 0.99).all()


@pytest.mark.parametrize("convention", ["lee", "reference"])
def test_desired_frame_branches_match_jax(convention):
    jcfg, tcfg = _configs("clamping", convention)
    b3 = np.array([[0, 0, 1], [0.12, 0, 0.9928], [0.5, 0.1, 0.86], [0.6, 0, 0.8],
                   [0, 0.3, 0.954], [-0.05, 0.05, 0.997]], np.float32)
    b3 /= np.linalg.norm(b3, axis=-1, keepdims=True)
    yaw = np.array([0.0, 0.0, 0.4, 1.0, -0.3, 2.0], np.float32)
    Rt = T._desired_frame(tcfg, torch.tensor(b3), torch.tensor(yaw)).numpy()
    Rj = np.asarray(J._desired_frame(jcfg, jnp.asarray(b3), jnp.asarray(yaw)))
    np.testing.assert_allclose(Rt, Rj, atol=1e-6)
    # row 1 takes the straight-up fallback (singular, |b3_z| >= 0.99), where
    # both packages set b1 = e1 without projecting it: not orthonormal
    rest = [0, 2, 3, 4, 5]
    np.testing.assert_allclose(Rt[rest] @ np.swapaxes(Rt[rest], -1, -2),
                               np.broadcast_to(np.eye(3), Rt[rest].shape), atol=1e-5)
    np.testing.assert_allclose(Rt[1][:, 0], [1.0, 0.0, 0.0])


def test_tilt_limit_matches_jax():
    jcfg, tcfg = _configs("clamping", "lee")
    rng = np.random.default_rng(3)
    b3 = rng.standard_normal((16, 3)).astype(np.float32)
    b3 /= np.linalg.norm(b3, axis=-1, keepdims=True)
    out = T._tilt_limit(tcfg, torch.tensor(b3)).numpy()
    np.testing.assert_allclose(out, np.asarray(J._tilt_limit(jcfg, jnp.asarray(b3))),
                               atol=1e-6)
    over = b3[:, 2] < np.cos(np.pi / 3)
    assert over.any() and (~over).any()
    np.testing.assert_allclose(out[over, 2], np.cos(np.pi / 3), atol=1e-6)


def test_controller_state_zeros_fields():
    jcfg, tcfg = _configs("clamping", "lee")
    js = J.ControllerState.zeros(jcfg, (2, 3))
    ts = T.ControllerState.zeros(tcfg, (2, 3), device="cpu")
    assert [f for f in js.__dataclass_fields__] == [f for f in ts.__dataclass_fields__]
    for name in js.__dataclass_fields__:
        a, b = np.asarray(getattr(js, name)), getattr(ts, name).numpy()
        assert a.shape == b.shape, name
        np.testing.assert_allclose(b.astype(np.float64), a.astype(np.float64), err_msg=name)
    assert ts.failsafe_count.dtype == torch.int32
    assert ts.last_torque_saturated.dtype == torch.bool
    assert T.GeometricConfig()._asdict() == J.GeometricConfig()._asdict()


def test_body_rate_command_matches_jax():
    jcfg, tcfg = _configs("clamping", "lee")
    d = _scenario("tilt_limited", 7)
    jcmd, _ = J.compute_body_rate_command(jcfg, *_jax_inputs(jcfg, d), DT)
    tcmd, _ = T.compute_body_rate_command(tcfg, *_torch_inputs(tcfg, d), DT)
    np.testing.assert_allclose(tcmd.thrust.numpy(), np.asarray(jcmd.thrust), atol=1e-6)
    np.testing.assert_allclose(tcmd.body_rates.numpy(), np.asarray(jcmd.body_rates),
                               atol=1e-5)


def test_facade_halves_gains_on_first_failsafe():
    """Bad tracking for longer than the trigger: both facades latch the
    failsafe, halve the gains once, and agree on every command."""
    jcfg, tcfg = _configs("clamping", "lee")
    jc, tc = J.GeometricController(jcfg), T.GeometricController(tcfg, device="cpu")
    far, vel = (8.0, 0.0, 4.0), (0.0, 3.0, 0.0)
    for i in range(9):
        ts = 0.01 * (i + 1)
        jd = JDroneState.create(timestamp=ts, position=(0.0, 0.0, 4.0), velocity=vel)
        td = DroneState.create(timestamp=ts, position=(0.0, 0.0, 4.0), velocity=vel,
                                device="cpu")
        jcmd = jc.compute_control(jd, far, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0))
        tcmd = tc.compute_control(td, far, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0))
        np.testing.assert_allclose(float(tcmd.thrust), float(jcmd.thrust), atol=1e-5)
        np.testing.assert_allclose(tcmd.torque.numpy(), np.asarray(jcmd.torque), atol=1e-5)
    assert bool(tc.state.failsafe_active)
    assert tc.config.kp_pos == tuple(0.5 * g for g in tcfg.kp_pos)
    assert tc.config.kd_att == jc.config.kd_att
    jm, tm = jc.get_performance_metrics(), tc.get_performance_metrics()
    assert jm.keys() == tm.keys()
    assert tm["total_samples"] == 9
    np.testing.assert_allclose(tm["mean_position_error"], jm["mean_position_error"],
                               rtol=1e-6)
    tc.reset()
    assert not bool(tc.state.failsafe_active) and not tc.position_errors
