"""The port's frozen configuration (``dart_planner_tpu_torch.config``) and
``HeartbeatConfig.from_central_config``, on the CPU, against the JAX
package.

- The cases of tests/test_config.py run against the port.
- The port's three YAML files equal the JAX package's byte for byte.
- Under every ``DART_*`` override of ``_ENV_OVERRIDES``, both packages give
  equal ``model_dump()``s, and each rejects the same bad values.
- ``PlanningConfig.to_se3_config()`` gives equal ``SE3MPCConfig`` fields
  (``safety_margin`` and the goal margin floor included).
- The DI container's planner, built from the config, plans its first plan
  from the web demo's ``obstacle_avoidance`` start as the JAX package's
  does: positions within 1e-3 m without obstacles; with the scenario's
  spheres, where a solve may branch at line-search near-ties (ROADMAP C.9),
  both thrust plans costed on the port's problem within 1e-4 relative. At
  ``DART_PREDICTION_HORIZON=100`` by cost alone (the test's docstring).
- ``RealTimeConfig.quartic_tasks`` gives equal task tables, and
  ``HeartbeatConfig.from_central_config`` equal values.

Both packages keep a config singleton; each test resets both around its
environment, so neither reads the other's cached value.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

import dart_planner_tpu.config as J
from dart_planner_tpu.apps.web_demo import DEMO_SCENARIOS
from dart_planner_tpu.common.di import create_default_container as j_container
from dart_planner_tpu.common.errors import ConfigurationError as JConfigurationError
from dart_planner_tpu.common.types import DroneState as JDroneState
from dart_planner_tpu.comms.heartbeat import HeartbeatConfig as JHeartbeatConfig
from dart_planner_tpu.config import frozen_config as J_fc
from dart_planner_tpu.planning.se3_mpc import SE3MPCPlanner as JPlanner
from dart_planner_tpu_torch import DroneState
from dart_planner_tpu_torch.common.di import create_default_container
from dart_planner_tpu_torch.common.errors import ConfigurationError
from dart_planner_tpu_torch.comms.heartbeat import HeartbeatConfig
from dart_planner_tpu_torch.config import (
    ConfigurationManager,
    DARTPlannerFrozenConfig,
    compute_max_torque_xyz,
    get_frozen_config,
    load_vehicle_params,
    reset_frozen_config,
)
from dart_planner_tpu_torch.config import frozen_config as T_fc
from dart_planner_tpu_torch.planning import se3_mpc as T

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("DART_"):
            monkeypatch.delenv(k, raising=False)
    reset_frozen_config()
    J.reset_frozen_config()
    yield
    reset_frozen_config()
    J.reset_frozen_config()


# ---- tests/test_config.py, run against the port ----
def test_defaults_load():
    cfg = get_frozen_config()
    assert cfg.hardware.control_frequency == 400.0
    assert cfg.planning.prediction_horizon == 20
    assert cfg.coordinate_frame.world_frame == "ENU"


def test_frozen_rejects_mutation():
    cfg = get_frozen_config()
    with pytest.raises(Exception):
        cfg.debug = True
    with pytest.raises(Exception):
        cfg.hardware.control_frequency = 1.0


def test_env_overrides(monkeypatch):
    monkeypatch.setenv("DART_CONTROL_FREQUENCY", "800")
    monkeypatch.setenv("DART_PREDICTION_HORIZON", "10")
    monkeypatch.setenv("DART_DEBUG", "true")
    cfg = ConfigurationManager().load()
    assert cfg.hardware.control_frequency == 800.0
    assert cfg.planning.prediction_horizon == 10
    assert cfg.debug is True


def test_bad_env_override(monkeypatch):
    monkeypatch.setenv("DART_ZMQ_PORT", "not-a-port")
    with pytest.raises(ConfigurationError):
        ConfigurationManager().load()


def test_validation_planning_vs_control(monkeypatch):
    monkeypatch.setenv("DART_CONTROL_FREQUENCY", "40")
    monkeypatch.setenv("DART_PLANNING_FREQUENCY", "50")
    with pytest.raises(ConfigurationError):
        ConfigurationManager().load()


def test_invalid_world_frame(monkeypatch):
    monkeypatch.setenv("DART_WORLD_FRAME", "XYZ")
    with pytest.raises(ConfigurationError):
        ConfigurationManager().load()


def test_planning_to_se3_config():
    se3 = get_frozen_config().planning.to_se3_config()
    assert isinstance(se3, T.SE3MPCConfig)
    assert se3.prediction_horizon == 20
    assert se3.dt == 0.1
    assert se3.obstacle_weight == 1000.0


def test_vehicle_params_and_torque():
    p = load_vehicle_params()
    assert p.mass == 1.5
    assert p.max_total_thrust == 48.0
    tau = compute_max_torque_xyz(p)
    assert isinstance(tau, np.ndarray)
    # x-geometry: 0.225*sin(45)*2*12 = 3.818 roll/pitch, 0.72 yaw
    np.testing.assert_allclose(tau[0], 0.225 * np.sin(np.pi / 4) * 24, rtol=1e-6)
    np.testing.assert_allclose(tau[2], 0.72, rtol=1e-6)
    assert 0 < p.hover_throttle_fraction < 1


def test_real_time_config_defaults_and_budget_validation():
    rt = get_frozen_config().real_time
    assert rt.control_loop_frequency_hz == 400.0
    assert rt.safety_priority > rt.control_priority > rt.planning_priority
    # a control budget exceeding the control period must be rejected
    with pytest.raises(Exception):
        T_fc.RealTimeConfig(control_loop_frequency_hz=1000.0, max_control_latency_ms=5.0)
    # frozen: mutation rejected
    with pytest.raises(Exception):
        rt.control_loop_frequency_hz = 100.0


def test_real_time_config_builds_scheduler_tasks():
    from dart_planner_tpu_torch.runtime.scheduler import QuarticTask, TaskPriority

    noop = lambda: None  # noqa: E731
    tasks = T_fc.RealTimeConfig().quartic_tasks(noop, noop, noop)
    assert all(isinstance(t, QuarticTask) for t in tasks)
    by_name = {t.name: t for t in tasks}
    assert by_name["safety"].priority == TaskPriority.CRITICAL
    assert by_name["control"].frequency_hz == 400.0
    # deadline fraction encodes the latency budget within the period
    assert by_name["control"].deadline_s == pytest.approx(2.5e-3)
    assert by_name["planning"].deadline_s == pytest.approx(40e-3)


def test_real_time_env_overrides(monkeypatch):
    monkeypatch.setenv("DART_RT_CONTROL_FREQUENCY", "250")
    monkeypatch.setenv("DART_RT_MAX_PLANNING_LATENCY_MS", "30")
    cfg = ConfigurationManager().load()
    assert cfg.real_time.control_loop_frequency_hz == 250.0
    assert cfg.real_time.max_planning_latency_ms == 30.0


# ---- the YAML copies ----
@pytest.mark.parametrize("name", ["defaults.yaml", "hardware.yaml", "airframes.yaml"])
def test_yaml_copies_equal_the_jax_packages(name):
    port = ROOT / "dart_planner_tpu_torch" / "config" / name
    jax = ROOT / "dart_planner_tpu" / "config" / name
    assert port.read_bytes() == jax.read_bytes()


def test_vehicle_params_and_airframes_equal_the_jax_packages():
    from dart_planner_tpu_torch.config import airframe, vehicle_params

    assert repr(load_vehicle_params()) == repr(J.load_vehicle_params())
    np.testing.assert_array_equal(compute_max_torque_xyz(load_vehicle_params()),
                                  J.compute_max_torque_xyz(J.load_vehicle_params()))
    assert vehicle_params.get_control_constants(load_vehicle_params()).keys() == \
        J.vehicle_params.get_control_constants(J.load_vehicle_params()).keys()
    tm, jm = airframe.AirframeConfigManager(), J.airframe.AirframeConfigManager()
    assert tm.list_airframes() == jm.list_airframes()
    for name in tm.list_airframes():
        t, j = tm.get(name), jm.get(name)
        assert repr(t) == repr(j)
        assert t.validate_config() == j.validate_config()
        assert t.get_thrust_to_weight_ratio() == j.get_thrust_to_weight_ratio()


# ---- every env override, in both packages ----
# DART_<NAME> -> (a good value, a value both must reject or None where the
# cast takes any string)
OVERRIDES = {
    "DART_ENVIRONMENT": ("production", None),
    "DART_DEBUG": ("yes", None),
    "DART_ZMQ_HOST": ("10.0.0.2", None),
    "DART_ZMQ_PORT": ("6000", "70000"),
    "DART_CONTROL_FREQUENCY": ("800", "0"),
    "DART_RT_CONTROL_FREQUENCY": ("250", "2000"),
    "DART_RT_PLANNING_FREQUENCY": ("20", "50"),
    "DART_RT_MAX_PLANNING_LATENCY_MS": ("30", "0.5"),
    "DART_PLANNING_FREQUENCY": ("25", "500"),
    "DART_PREDICTION_HORIZON": ("10", "1"),
    "DART_PLANNING_DT": ("0.05", "2.0"),
    "DART_MAX_VELOCITY": ("12.5", "fast"),
    "DART_LOG_LEVEL": ("DEBUG", None),
    "DART_WORLD_FRAME": ("NED", "XYZ"),
    "DART_SECRET_KEY": ("s3cret", None),
}


def test_override_table_equals_the_jax_packages():
    assert set(OVERRIDES) == set(T_fc._ENV_OVERRIDES) == set(J_fc._ENV_OVERRIDES)
    for env, (section, field, _) in T_fc._ENV_OVERRIDES.items():
        assert J_fc._ENV_OVERRIDES[env][:2] == (section, field)


@pytest.mark.parametrize("env", sorted(OVERRIDES))
def test_env_override_matches_jax(monkeypatch, env):
    good, bad = OVERRIDES[env]
    base = ConfigurationManager().load().model_dump()
    monkeypatch.setenv(env, good)
    t, j = ConfigurationManager().load(), J.ConfigurationManager().load()
    assert isinstance(t, DARTPlannerFrozenConfig)
    assert t.model_dump() == j.model_dump() != base
    assert get_frozen_config().model_dump() == J.get_frozen_config().model_dump()
    if bad is None:
        return
    monkeypatch.setenv(env, bad)
    with pytest.raises(ConfigurationError):
        ConfigurationManager().load()
    with pytest.raises(JConfigurationError):
        J.ConfigurationManager().load()


# ---- the solver the config builds ----
@pytest.mark.parametrize("env", [{}, {"DART_PREDICTION_HORIZON": "10", "DART_PLANNING_DT": "0.05"}])
def test_to_se3_config_equals_the_jax_packages(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    t = get_frozen_config().planning.to_se3_config()._asdict()
    j = J.get_frozen_config().planning.to_se3_config()._asdict()
    assert list(t) == list(j)
    for field in t:
        assert t[field] == j[field], field
    assert t["safety_margin"] == 1.5 and t["goal_margin_floor"] == 0.6
    assert t["prediction_horizon"] == int(env.get("DART_PREDICTION_HORIZON", 20))


def _finalized_cost(planner, state, u) -> float:
    """The float32 cost of thrusts ``u`` on the planner's problem at
    ``state``: the solve's own (``costs.condensed_cost`` under the solver's
    gravity)."""
    prob, config = planner._problem(state), planner.config
    g = T._gravity(config, u.dtype, u.device)
    return float(T.costs.condensed_cost(u, prob, config.weights, config.dt, config.mass, g))


@pytest.mark.parametrize("horizon", [None, "100"], ids=["default", "N100"])
@pytest.mark.parametrize("with_obstacles", [False, True])
def test_config_planner_first_plan_matches_jax(monkeypatch, with_obstacles, horizon):
    """The DI container's planner (the config's solver) plans once from the
    demo's ``obstacle_avoidance`` start in each package: at the default
    horizon, and at ``DART_PREDICTION_HORIZON=100``, the longest the frozen
    config accepts (four steps a lane of kernel B1 on the card).

    At N=100 the default budget branches in float32 (ROADMAP C.21), so the
    plans are held by their cost: without obstacles both plans' finalized
    costs agree to 1e-4 relative (measured 6.2e-7, the positions 0.013 m
    apart); with them the plans settle in different basins (2.56 m apart)
    and the port's costs no more than the JAX plan's plus 1e-4 relative
    (measured 1.26e-3 below it)."""
    if horizon is not None:
        monkeypatch.setenv("DART_PREDICTION_HORIZON", horizon)
    sc = DEMO_SCENARIOS["obstacle_avoidance"]
    tp = create_default_container(device="cpu").resolve(T.SE3MPCPlanner)
    jp = j_container().resolve(JPlanner)
    assert tp.device == torch.device("cpu")
    assert tp.config._asdict() == jp.config._asdict()
    if with_obstacles:
        for o in sc["obstacles"]:
            tp.add_obstacle(o["pos"], o["radius"])
            jp.add_obstacle(np.float32(o["pos"]), o["radius"])
    ts = DroneState.create(position=sc["start_pos"], device="cpu")
    js = JDroneState.create(position=sc["start_pos"])
    tt = tp.plan_trajectory(ts, sc["goal_pos"])
    jt = jp.plan_trajectory(js, np.float32(sc["goal_pos"]))
    t_pos = tt.positions.numpy()
    j_pos = np.asarray(jt.positions, np.float32)
    N = get_frozen_config().planning.prediction_horizon
    assert N == (20 if horizon is None else int(horizon))
    assert t_pos.shape == j_pos.shape == (N, 3)
    assert np.isfinite(t_pos).all()
    if not with_obstacles and horizon is None:
        np.testing.assert_allclose(t_pos, j_pos, atol=1e-3)
        return
    u_j = torch.tensor(np.asarray(jp.last_solution, np.float32))
    c_t = _finalized_cost(tp, ts, tp.last_solution)
    c_j = _finalized_cost(tp, ts, u_j)
    if with_obstacles and horizon is not None:
        assert c_t <= c_j + 1e-4 * abs(c_j), (c_t, c_j)
    else:
        assert abs(c_t - c_j) <= 1e-4 * abs(c_j), (c_t, c_j)


# ---- the scheduler tasks and the heartbeat ----
@pytest.mark.parametrize("env", [{}, {"DART_RT_CONTROL_FREQUENCY": "250",
                                      "DART_RT_MAX_PLANNING_LATENCY_MS": "30"}])
def test_quartic_tasks_equal_the_jax_packages(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)

    def table(cfg):
        noop = lambda: None  # noqa: E731
        return [(t.name, t.frequency_hz, t.priority.name, int(t.priority.value),
                 t.deadline_fraction, t.deadline_s)
                for t in cfg.real_time.quartic_tasks(noop, noop, noop)]

    t, j = table(get_frozen_config()), table(J.get_frozen_config())
    assert t == j and len(t) == 3


def test_heartbeat_from_central_config_equals_the_jax_packages(tmp_path):
    assert HeartbeatConfig.from_central_config() == HeartbeatConfig(100, 500)
    assert (HeartbeatConfig.from_central_config().__dict__
            == JHeartbeatConfig.from_central_config().__dict__)
    path = tmp_path / "heartbeat.yaml"
    path.write_text("communication:\n  heartbeat_interval_ms: 40\n"
                    "  heartbeat_timeout_ms: 250\n")
    get_frozen_config(path)
    J.get_frozen_config(path)
    t, j = HeartbeatConfig.from_central_config(), JHeartbeatConfig.from_central_config()
    assert (t.interval_ms, t.timeout_ms) == (40, 250)
    assert t.__dict__ == j.__dict__
