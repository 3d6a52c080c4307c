"""The port's common modules and tuning profiles (dart_planner_tpu_torch/
common/types.py, frames.py, metrics.py; control/tuning_profiles.py) against
the JAX package's: the frame transforms exactly, the profiles field by
field, and the Prometheus exposition character for character for the same
records."""

import json
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dart_planner_tpu.common import frames as JF
from dart_planner_tpu.common import metrics as JMet
from dart_planner_tpu.common import types as JT
from dart_planner_tpu.control import tuning_profiles as JP
from dart_planner_tpu_torch.common import errors, frames, metrics, types
from dart_planner_tpu_torch.control import GeometricConfig
from dart_planner_tpu_torch.control import tuning_profiles as TP


def test_estimated_state_to_drone_state_matches_jax():
    rng = np.random.default_rng(0)
    v = [rng.normal(0, 1, 3).astype(np.float32) for _ in range(6)]
    js = JT.EstimatedState(timestamp=jnp.float32(1.5), pose=JT.Pose(*map(jnp.asarray, v[:2])),
                           twist=JT.Twist(*map(jnp.asarray, v[2:4])),
                           accel=JT.Accel(*map(jnp.asarray, v[4:])), source="ekf")
    t = [torch.tensor(x) for x in v]
    ts = types.EstimatedState(timestamp=torch.tensor(1.5), pose=types.Pose(*t[:2]),
                              twist=types.Twist(*t[2:4]), accel=types.Accel(*t[4:]),
                              source="ekf")
    jd, td = js.to_drone_state(), ts.to_drone_state()
    for name in ("timestamp", "position", "velocity", "attitude", "angular_velocity"):
        np.testing.assert_array_equal(getattr(td, name).numpy(), np.asarray(getattr(jd, name)))
    assert ts.replace(source="gps").source == "gps" and ts.source == "ekf"
    assert types.EstimatedState(ts.timestamp, ts.pose, ts.twist, ts.accel).source == "unknown"


@pytest.mark.parametrize("frame", list(frames.WorldFrame))
def test_frames_match_jax(frame):
    jframe = JF.WorldFrame(frame.value)
    v = np.random.default_rng(1).normal(0, 1, (4, 3)).astype(np.float32)
    np.testing.assert_array_equal(frames.up_vector(frame, device="cpu").numpy(),
                                  np.asarray(JF.up_vector(jframe), np.float32))
    for name in ("enu_to_ned", "ned_to_enu"):
        np.testing.assert_array_equal(getattr(frames, name)(torch.tensor(v)).numpy(),
                                      np.asarray(getattr(JF, name)(v), np.float32))
    assert np.array_equal(frames.ENU_TO_NED, JF.ENU_TO_NED)
    assert np.array_equal(frames.NED_TO_ENU, JF.NED_TO_ENU)
    back = frames.ned_to_enu(frames.enu_to_ned(torch.tensor(v)))
    assert torch.equal(back, torch.tensor(v))


def test_coordinate_frame_manager_is_thread_local_context():
    base = frames.get_coordinate_frame_manager()
    assert base is frames.get_coordinate_frame_manager()
    assert base.world_frame == frames.WorldFrame.ENU
    with frames.CoordinateFrameManager(frames.WorldFrame.NED, device="cpu") as ned:
        assert frames.get_coordinate_frame_manager() is ned
        assert float(ned.get_gravity_vector()[2]) == pytest.approx(9.81)
        assert float(ned.get_up_vector()[2]) == -1.0
    assert frames.get_coordinate_frame_manager() is base


@pytest.mark.parametrize("name", sorted(JP.list_profiles()))
def test_profiles_match_jax(name):
    assert TP.get_controller_config(name)._asdict() == JP.get_controller_config(name)._asdict()
    assert TP.list_profiles()[name] == JP.list_profiles()[name]
    assert isinstance(TP.get_controller_config(name), GeometricConfig)


def test_profile_registry_and_recommendations():
    for scenario in ("sitl", "HARDWARE", "racing", "tracking", "default", "unknown"):
        assert TP.get_recommended_profile(scenario) == JP.get_recommended_profile(scenario)
    with pytest.raises(errors.ConfigurationError, match="Unknown profile"):
        TP.get_controller_config("nope")
    custom = GeometricConfig(kp_pos=(1.0, 1.0, 1.0))
    TP.add_custom_profile("test_custom", custom)
    try:
        assert TP.get_controller_config("test_custom") is custom
        assert TP.list_profiles()["test_custom"] == "test_custom"
    finally:
        TP._PROFILES.pop("test_custom")


def _record(m):
    for i in range(40):
        m.record("plan ms", 0.5 * i)
        m.record("ctrl.loop", 2.0 + (i % 7))
    m.increment("replans", 3)
    m.increment("errors-total")


def test_exposition_is_jax_text_for_the_same_records():
    ours, ref = metrics.MetricsManager(), JMet.MetricsManager()
    _record(ours)
    _record(ref)
    assert ours.prometheus_exposition() == ref.prometheus_exposition()
    assert ours.all_summaries() == ref.all_summaries()
    assert ours.prometheus_exposition(prefix="x") == ref.prometheus_exposition(prefix="x")
    ours.reset()
    assert ours.summary("plan ms") is None and ours.prometheus_exposition() == "\n"


def test_bounded_history_timer_and_global():
    m = metrics.MetricsManager(max_samples=10)
    for i in range(25):
        m.record("x", i)
    assert m.summary("x")["count"] == 10 and m.summary("x")["min"] == 15.0
    with m.timer("t"):
        pass
    assert m.summary("t")["count"] == 1 and m.summary("t")["min"] >= 0.0
    assert metrics.get_metrics() is metrics.get_metrics()


def test_serve_exposes_metrics_on_localhost():
    m = metrics.MetricsManager()
    _record(m)
    server = m.serve(port=0)
    try:
        port = server.server_address[1]
        body = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10).read()
        assert body.decode() == m.prometheus_exposition()
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/other", timeout=10)
    finally:
        server.shutdown()
        server.server_close()


def test_device_trace_writes_a_trace(tmp_path):
    with metrics.device_trace(str(tmp_path)):
        torch.ones(64).cumsum(0)
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1
    assert "traceEvents" in json.loads(traces[0].read_text())
