"""The port's state estimation (dart_planner_tpu_torch/estimation/) against
the JAX package on the same numpy inputs: the EKF's predict and position
and velocity updates, the fleet as one batched call (JAX vmaps), and the
PX4 EKF2 and simulator ground-truth adapters (the cases of
tests/test_estimation_recovery.py's estimation section).

Tolerances: the filter state x at atol 1e-5 and P at atol 1e-5 + rtol
1e-4 after 200 float32 steps (both packages keep every product in exact
fp32; they sum in another order, so they part by rounding only); the
adapters' fields exactly, as they are copies of the same floats.
"""

from unittest.mock import MagicMock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dart_planner_tpu import estimation as J
from dart_planner_tpu.hardware import VehicleIOFactory as JFactory
from dart_planner_tpu_torch import estimation as T
from dart_planner_tpu_torch import interop
from dart_planner_tpu_torch.estimation import ekf as T_ekf
from dart_planner_tpu_torch.hardware import VehicleIOFactory as TFactory


def _same(js, ts, what=""):
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x, np.float32), atol=1e-5,
                               rtol=0, err_msg=f"x {what}")
    np.testing.assert_allclose(ts.P.numpy(), np.asarray(js.P, np.float32), atol=1e-5,
                               rtol=1e-4, err_msg=f"P {what}")


def test_ekf_converges_on_noisy_position():
    jcfg = J.EKFConfig()
    tcfg = interop.ekf_config_from_jax_fields(jcfg)
    rng = np.random.default_rng(0)
    dt = 0.01
    true_p = np.zeros(3)
    true_v = np.array([1.0, 0.5, 0.0])
    p0 = (np.zeros(3) + rng.normal(0, 1, 3)).astype(np.float32)
    js = J.ekf_init(p0)
    ts = T.ekf_init(p0, device="cpu")
    _same(js, ts, "init")
    for k in range(200):
        true_p = true_p + true_v * dt
        js = J.ekf_predict(jcfg, js, jnp.zeros(3, jnp.float32), dt)
        ts = T.ekf_predict(tcfg, ts, torch.zeros(3), dt)
        if k % 5 == 0:
            z = (true_p + rng.normal(0, 0.05, 3)).astype(np.float32)
            js = J.ekf_update_position(jcfg, js, z)
            ts = T.ekf_update_position(tcfg, ts, z)
        if k % 50 == 0:
            _same(js, ts, f"step {k}")
    _same(js, ts, "end")
    p_est, v_est = ts.x[:3].numpy(), ts.x[3:6].numpy()
    assert np.linalg.norm(p_est - true_p) < 0.1
    assert np.linalg.norm(v_est - true_v) < 0.3  # velocity inferred from positions


def test_ekf_velocity_update_and_accel_input():
    """Predict with a non-zero world acceleration, then fuse velocity and
    position, from a JAX state carried across with interop."""
    jcfg = J.EKFConfig(accel_noise=0.8, vel_meas_noise=0.2)
    tcfg = interop.ekf_config_from_jax_fields(jcfg)
    rng = np.random.default_rng(1)
    js = J.ekf_init(rng.normal(0, 1, 3).astype(np.float32),
                    rng.normal(0, 1, 3).astype(np.float32), pos_var=2.0)
    ts = interop.ekf_state_from_numpy({"x": np.asarray(js.x), "P": np.asarray(js.P)})
    for k in range(40):
        a = rng.normal(0, 2, 3).astype(np.float32)
        js = J.ekf_predict(jcfg, js, jnp.asarray(a), 0.02)
        ts = T.ekf_predict(tcfg, ts, torch.tensor(a), 0.02)
        z = rng.normal(0, 1, 3).astype(np.float32)
        if k % 2:
            js = J.ekf_update_velocity(jcfg, js, z)
            ts = T.ekf_update_velocity(tcfg, ts, z)
        else:
            js = J.ekf_update_position(jcfg, js, z)
            ts = T.ekf_update_position(tcfg, ts, z)
    _same(js, ts)
    P = ts.P.numpy()
    np.testing.assert_allclose(P, P.T, atol=1e-5)


def test_ekf_vmapped_fleet():
    """JAX vmaps the filter over B vehicles; the port takes (B, 9) in one
    call."""
    jcfg = J.EKFConfig()
    tcfg = T.EKFConfig()
    B = 16
    rng = np.random.default_rng(2)
    p0 = rng.random((B, 3)).astype(np.float32)
    js = J.ekf_init(p0)
    ts = T.ekf_init(torch.tensor(p0))
    assert ts.x.device.type == "cpu"  # a tensor keeps its device
    accel = rng.normal(0, 1, (B, 3)).astype(np.float32)
    meas = rng.normal(0, 1, (B, 3)).astype(np.float32)
    js = jax.vmap(lambda s, a: J.ekf_predict(jcfg, s, a, 0.01))(js, jnp.asarray(accel))
    ts = T.ekf_predict(tcfg, ts, torch.tensor(accel), 0.01)
    js = jax.vmap(lambda s, z: J.ekf_update_position(jcfg, s, z))(js, jnp.asarray(meas))
    ts = T.ekf_update_position(tcfg, ts, torch.tensor(meas))
    assert ts.x.shape == (B, 9) and ts.P.shape == (B, 9, 9)
    assert torch.isfinite(ts.P).all()
    _same(js, ts)


def test_ekf_init_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        T.ekf_init(np.zeros(3))
    assert T_ekf.ekf_init(np.zeros(3), device="cpu").x.shape == (9,)


def _px4_connection():
    conn = MagicMock()
    att = MagicMock()
    att.get_type.return_value = "ATTITUDE"
    att.roll, att.pitch, att.yaw = 0.1, -0.05, 1.0
    att.rollspeed, att.pitchspeed, att.yawspeed = 0.01, 0.0, -0.02
    odom = MagicMock()
    odom.get_type.return_value = "ODOMETRY"
    odom.x, odom.y, odom.z = 1.0, 2.0, 3.0
    odom.roll, odom.pitch, odom.yaw = 0.1, -0.05, 1.0
    odom.vx, odom.vy, odom.vz = 0.5, 0.0, -0.1
    odom.rollspeed, odom.pitchspeed, odom.yawspeed = 0, 0, 0
    gpi = MagicMock()
    gpi.get_type.return_value = "GLOBAL_POSITION_INT"
    gpi.lat, gpi.lon, gpi.alt = 473977418, 85455939, 488000
    gpi.vx, gpi.vy, gpi.vz = 120, -40, 5
    conn.recv_match.side_effect = [att, odom, gpi, None]
    return conn


def test_px4_adapter_parses_messages():
    jest = J.PX4EKF2StateEstimator(_px4_connection())
    test = T.PX4EKF2StateEstimator(_px4_connection(), device="cpu")
    jest.update()
    test.update()
    js, ts = jest.get_latest(), test.get_latest()
    assert ts is not None and ts.source == "PX4_EKF2"
    for name in ("position", "orientation"):
        np.testing.assert_array_equal(getattr(ts.pose, name).numpy(),
                                      np.asarray(getattr(js.pose, name)))
    for name in ("linear", "angular"):
        np.testing.assert_array_equal(getattr(ts.twist, name).numpy(),
                                      np.asarray(getattr(js.twist, name)))
    ds = ts.to_drone_state()
    np.testing.assert_allclose(ds.velocity.numpy(), [1.2, -0.4, 0.05], atol=1e-6)


def test_sim_ground_truth_estimator():
    jv = JFactory.create("simulated", {"initial_position": (1.0, 2.0, 3.0)})
    tv = TFactory.create("simulated", {"initial_position": (1.0, 2.0, 3.0), "device": "cpu"})
    jest, test = J.SimGroundTruthEstimator(jv), T.SimGroundTruthEstimator(tv)
    jest.update()
    test.update()
    js, ts = jest.get_latest(), test.get_latest()
    assert ts.source == "sim_ground_truth"
    np.testing.assert_allclose(ts.pose.position.numpy(), [1, 2, 3], atol=1e-6)
    for name in ("position", "orientation"):
        np.testing.assert_array_equal(getattr(ts.pose, name).numpy(),
                                      np.asarray(getattr(js.pose, name)))
    np.testing.assert_array_equal(ts.twist.linear.numpy(), np.asarray(js.twist.linear))
