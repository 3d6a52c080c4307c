"""The port's hardware adapters on the CPU: the MAVLink and AirSim adapters,
the secure command channel, the motor latency calibration and the
motor-mixing schema (dart_planner_tpu_torch/hardware/).

The cases of tests/test_hardware.py:167-205 (the MAVLink adapter over a
mocked ``mavutil``), tests/test_hardware_extended.py (AirSim over a mock
client, the calibration, the secure channel), the mixing-schema cases of
tests/test_credential_helpers_mixing.py and tests/test_hardware_mission.py's
mocked MAVLink missions (:227-285) run against the port, with
``device="cpu"``. Held against the JAX package on the same inputs:

- the same scripted MAVLink link (``chip_smoke.ScriptedMavlink``, the copy
  of the JAX test's ``_ScriptedMavlink``, its clock fixed) and the same
  AirSim mock give equal polled states, atol 0 (both round each field to
  float32 once; timestamps aside: both put epoch seconds into float32);
  the messages sent for the same commands agree to atol 1e-6;
- the calibration's statistics on the same measurements, exactly;
- a token the JAX package signs passes the port's secure channel;
- the mixing schema builds the same ``MotorMixingConfig`` and rejects the
  same inputs with the same errors (location, message, type).

The missions run the scheduler on the wall clock with the JAX test's
``_fast_config(planning_frequency=5.0)``; their planner is the small
``SE3MPCConfig(max_iterations=4, gn_warmup_iterations=2,
tail_iterations=0)`` of tests/test_torch_hardware_mission.py, and the
completing one keeps that file's one retry.
"""

import asyncio
import time
from types import SimpleNamespace
from unittest.mock import MagicMock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dart_planner_tpu.common.types import BodyRateCommand as JBodyRateCommand
from dart_planner_tpu.common.types import ControlCommand as JControlCommand
from dart_planner_tpu.hardware import airsim_interface as J_airsim
from dart_planner_tpu.hardware import mavlink_adapter as J_mavlink
from dart_planner_tpu.hardware import mixing_schema as J_mixing
from dart_planner_tpu.hardware import motor_calibration as J_calibration
from dart_planner_tpu.security.auth import AuthManager as JAuthManager
from dart_planner_tpu.security.auth import Role as JRole
from dart_planner_tpu_torch.common.errors import (
    HardwareError,
    SecurityError,
    UnsupportedCommandError,
)
from dart_planner_tpu_torch.common.types import BodyRateCommand, ControlCommand
from dart_planner_tpu_torch.hardware import (
    AirSimDroneInterface,
    AirSimVehicleIO,
    MotorLatencyCalibrator,
    MotorMixingModel,
    SecureHardwareInterface,
    SimulatedVehicleIO,
    VehicleIOFactory,
    validate_motor_mixing,
)
from dart_planner_tpu_torch.hardware.mavlink_adapter import _HAS_MAVLINK, MavlinkVehicleIO
from dart_planner_tpu_torch.hardware.mission import (
    MissionConfig,
    MissionRunner,
    start_mission,
)
from dart_planner_tpu_torch.hardware.motor_calibration import LatencyMeasurement
from dart_planner_tpu_torch.hardware.secure_interface import ConnectionState
from dart_planner_tpu_torch.planning.se3_mpc import SE3MPCConfig, SE3MPCPlanner
from dart_planner_tpu_torch.security.auth import AuthManager, Role
from test_hardware_extended import MockAirSimClient as JMockAirSimClient

SMALL = SE3MPCConfig(max_iterations=4, gn_warmup_iterations=2, tail_iterations=0)
STATE_FIELDS = ("position", "velocity", "attitude", "angular_velocity")


def run(coro):
    return asyncio.get_event_loop_policy().new_event_loop().run_until_complete(coro)


def _fast_config(**kw):
    base = dict(
        control_frequency=100.0,
        planning_frequency=10.0,
        waypoint_tolerance=0.8,
        mission_timeout_s=240.0,
    )
    base.update(kw)
    return MissionConfig(**base)


def _assert_states_equal(port, jax_state):
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(
            getattr(port, f).numpy(), np.asarray(getattr(jax_state, f)), err_msg=f
        )


# ---------------------------------------------------------------- MAVLink

def _mock_mavutil():
    mock_mavutil = MagicMock()
    conn = MagicMock()
    mock_mavutil.mavlink_connection.return_value = conn
    conn.wait_heartbeat.return_value = object()
    ack = MagicMock()
    ack.result = 0
    conn.recv_match.side_effect = lambda **kw: (
        ack if kw.get("type") == "COMMAND_ACK" else None
    )
    return mock_mavutil, conn


def test_mavlink_adapter_with_mock():
    mock_mavutil, conn = _mock_mavutil()

    async def main():
        v = MavlinkVehicleIO({"connection_string": "udp:localhost:14550"},
                             mavutil=mock_mavutil, device="cpu")
        assert await v.connect()
        assert await v.arm()
        assert await v.takeoff(5.0)
        assert await v.land()
        await v.emergency_stop()
        return v

    v = asyncio.run(main())
    assert conn.mav.command_long_send.call_count == 4
    assert v.armed


def test_mavlink_adapter_requires_pymavlink():
    if not _HAS_MAVLINK:
        with pytest.raises(HardwareError):
            MavlinkVehicleIO({}, device="cpu")


def test_mavlink_state_lives_on_the_given_device():
    """The adapter's state is one packed tensor on its device, float32."""
    link = chip_smoke.ScriptedMavlink((2.0, 0.0, 3.0))
    v = MavlinkVehicleIO({}, mavutil=link, device="cpu")
    run(v.connect())
    st = v.poll_state()
    assert all(getattr(st, f).device == torch.device("cpu") for f in STATE_FIELDS)
    assert st.position.dtype == torch.float32 and st.timestamp.shape == ()
    assert v.get_state() is not None


def test_mavlink_states_and_messages_match_jax(monkeypatch):
    """The same scripted link, its clock fixed: both adapters poll equal
    states (atol 0) and send the same COMMAND_LONGs and body-rate targets
    (atol 1e-6)."""
    clock = {"t": 1.7e9}
    monkeypatch.setattr(time, "time", lambda: clock["t"])
    goal = (2.0, -1.0, 3.5)
    port_link = chip_smoke.ScriptedMavlink(goal, travel_s=3.0)
    jax_link = chip_smoke.ScriptedMavlink(goal, travel_s=3.0)
    port = MavlinkVehicleIO({"connection_string": "udp:mock"}, mavutil=port_link, device="cpu")
    jax_v = J_mavlink.MavlinkVehicleIO({"connection_string": "udp:mock"}, mavutil=jax_link)
    run(port.connect())
    run(jax_v.connect())
    for k in range(6):
        clock["t"] = 1.7e9 + 0.37 * k
        _assert_states_equal(port.poll_state(), jax_v.poll_state())
        assert port.heartbeat_age() == jax_v.heartbeat_age()
    rng = np.random.default_rng(0)
    for _ in range(5):
        rates = rng.normal(size=3).astype(np.float32)
        thrust = np.float32(rng.uniform(0.2, 0.9))
        port.send_body_rate_target(BodyRateCommand(
            thrust=torch.tensor(thrust), body_rates=torch.from_numpy(rates)))
        jax_v.send_body_rate_target(JBodyRateCommand(
            thrust=jnp.asarray(thrust), body_rates=jnp.asarray(rates)))
    for v in (port, jax_v):
        run(v.arm())
        run(v.takeoff(4.0))
        run(v.land())
        run(v.emergency_stop())
    assert port_link.commands == jax_link.commands
    assert len(port_link.targets) == len(jax_link.targets) == 5
    for a, b in zip(port_link.targets, jax_link.targets):
        assert a[:5] == b[:5]
        np.testing.assert_allclose(a[5:], b[5:], rtol=0, atol=1e-6)
        assert all(type(x) is float for x in a[5:])


def test_mocked_mavlink_mission_to_completion():
    """tests/test_hardware_mission.py:227 on the port: connect -> arm ->
    start_mission -> body-rate targets + replans -> waypoint reached."""
    last = None
    for _ in range(2):
        try:
            _run_mavlink_mission()
            return
        except AssertionError as e:
            last = e
    raise last


def _run_mavlink_mission():
    goal = (2.0, 0.0, 3.0)
    mock = chip_smoke.ScriptedMavlink(goal_enu=goal, travel_s=3.0)

    async def main():
        vehicle = MavlinkVehicleIO({"connection_string": "udp:mock"}, mavutil=mock,
                                   device="cpu")
        await vehicle.connect()
        report = await start_mission(
            vehicle,
            [goal],
            config=_fast_config(planning_frequency=5.0, mission_timeout_s=60.0),
            planner=SE3MPCPlanner(SMALL, device="cpu"),
        )
        return vehicle, report

    vehicle, report = asyncio.run(main())
    assert report["mission_complete"], report
    assert report["waypoints_reached"] == 1
    assert mock.body_rate_targets > 10  # the control loop actually ran
    assert np.isfinite(np.array([t[5:9] for t in mock.targets])).all()
    assert report["avg_planning_time_ms"] > 0.0
    assert vehicle.armed  # runner armed the vehicle itself


def test_mocked_mavlink_heartbeat_loss_failsafe():
    """tests/test_hardware_mission.py:258 on the port: the scripted link
    stops heartbeating; the safety monitor must ground the mission."""
    mock = chip_smoke.ScriptedMavlink(
        goal_enu=(30.0, 0.0, 3.0), travel_s=1e6, heartbeat_until=0.5
    )

    async def main():
        vehicle = MavlinkVehicleIO({"connection_string": "udp:mock"}, mavutil=mock,
                                   device="cpu")
        await vehicle.connect()
        runner = MissionRunner(
            vehicle,
            _fast_config(
                planning_frequency=5.0,
                heartbeat_timeout_s=1.0,
                mission_timeout_s=60.0,
            ),
            planner=SE3MPCPlanner(SMALL, device="cpu"),
        )
        return await runner.start_mission([(30.0, 0.0, 3.0)])

    report = asyncio.run(main())
    assert not report["mission_complete"]
    assert report["failsafe_reason"] == "heartbeat lost", report


# ----------------------------------------------------------------- AirSim

def test_airsim_requires_client_or_package():
    with pytest.raises(HardwareError):
        AirSimDroneInterface(device="cpu")


def test_airsim_state_ned_to_enu_conversion():
    iface = AirSimDroneInterface(client=JMockAirSimClient(), device="cpu")
    run(iface.connect())
    st = run(iface.get_state())
    # NED (n=1, e=2, d=-3) -> ENU (e=2, n=1, u=3)
    np.testing.assert_allclose(st.position.numpy(), [2.0, 1.0, 3.0])
    np.testing.assert_allclose(st.velocity.numpy(), [0.2, 0.1, 0.3])


def test_airsim_command_and_metrics():
    client = JMockAirSimClient()
    iface = AirSimDroneInterface(client=client, device="cpu")
    # rejected before connect
    cmd = ControlCommand(thrust=torch.tensor(10.0), torque=torch.zeros(3))
    assert not run(iface.send_control_command(cmd))
    run(iface.connect())
    assert run(iface.send_control_command(cmd))
    m = iface.get_performance_metrics()
    assert m["counters"]["commands_sent"] == 1
    assert m["counters"]["command_rejected"] == 1


def test_airsim_vehicle_io_registered_and_mission():
    assert "airsim" in VehicleIOFactory.list_available()
    vio = AirSimVehicleIO(client=JMockAirSimClient(), device="cpu")
    run(vio.connect())
    run(vio.takeoff(3.0))
    assert vio.iface.armed
    st = run(vio.poll_state())
    assert vio.get_state() is st
    run(vio.land())
    assert not vio.iface.armed
    status = vio.get_status()
    assert status["connected"] and not status["armed"]


def test_airsim_attitude_ned_to_enu():
    """East-facing drone: NED yaw=+pi/2 must become ENU yaw=0."""
    client = JMockAirSimClient()
    q = SimpleNamespace(w_val=np.cos(np.pi / 4), x_val=0.0, y_val=0.0,
                        z_val=np.sin(np.pi / 4))
    base = client.getMultirotorState()

    def east_state(name=""):
        k = base.kinematics_estimated
        return SimpleNamespace(kinematics_estimated=SimpleNamespace(
            position=k.position, linear_velocity=k.linear_velocity,
            angular_velocity=k.angular_velocity, orientation=q))

    client.getMultirotorState = east_state
    iface = AirSimDroneInterface(client=client, device="cpu")
    run(iface.connect())
    st = run(iface.get_state())
    assert abs(float(st.attitude[2])) < 1e-6  # ENU yaw = 0


def test_airsim_device_is_a_keyword_not_a_config_key():
    """``AirSimConfig(**config)`` rejects unknown keys, so the device is a
    keyword; the adapter's state lives there."""
    with pytest.raises(TypeError):
        AirSimVehicleIO({"device": "cpu"}, client=JMockAirSimClient())
    vio = AirSimVehicleIO(client=JMockAirSimClient(), device="cpu")
    assert vio.device == vio.iface.device == torch.device("cpu")


@pytest.mark.parametrize("make_client", [JMockAirSimClient, chip_smoke.MockAirSimClient],
                         ids=["level", "tilted"])
def test_airsim_states_and_commands_match_jax(make_client):
    """The same mock client: equal polled states (atol 0; the NED -> ENU
    conversions are the JAX package's, bit for bit) and the same client
    calls for the same commands (atol 1e-6)."""
    port_client, jax_client = make_client(), make_client()
    port = AirSimVehicleIO(client=port_client, device="cpu")
    jax_v = J_airsim.AirSimVehicleIO(client=jax_client)
    rng = np.random.default_rng(1)
    wrenches = [(np.float32(rng.uniform(0, 25)), rng.normal(size=3).astype(np.float32))
                for _ in range(4)]
    for v, cmd in ((port, lambda t, q: ControlCommand(thrust=torch.tensor(t),
                                                       torque=torch.from_numpy(q))),
                   (jax_v, lambda t, q: JControlCommand(thrust=jnp.asarray(t),
                                                        torque=jnp.asarray(q)))):
        run(v.connect())
        run(v.takeoff(3.0))
        for t, q in wrenches:
            assert run(v.iface.send_control_command(cmd(t, q)))
        run(v.land())
    _assert_states_equal(run(port.poll_state()), run(jax_v.poll_state()))
    assert len(port_client.calls) == len(jax_client.calls)
    for a, b in zip(port_client.calls, jax_client.calls):
        if isinstance(a, tuple) and a[0] == "rates":
            np.testing.assert_allclose(a[1][:5], b[1][:5], rtol=0, atol=1e-6)
            assert a[1][5:] == b[1][5:]
        else:
            assert a == b


# -------------------------------------------------------- calibration

class FakeStepAdapter:
    """Actuator model: holds the previous output during the latency window,
    then settles at the new target (alternating steps up/down)."""

    def __init__(self, latency_s=0.005):
        self.latency_s = latency_s
        self._cmd_time = None
        self._current = 0.0
        self._target = 0.0

    def send_test_command(self, cmd):
        self._current = self.get_response_state()["throttle"]
        self._target = 0.0 if self._current > 0 else cmd["magnitude"]
        self._cmd_time = time.perf_counter()

    def get_response_state(self):
        if (
            self._cmd_time is not None
            and time.perf_counter() - self._cmd_time >= self.latency_s
        ):
            return {"throttle": self._target}
        return {"throttle": self._current}


def test_latency_calibration_measures_step_response():
    cal = MotorLatencyCalibrator(
        FakeStepAdapter(latency_s=0.005),
        config={"num_samples": 6, "settle_time_s": 0.0},
    )
    result = cal.calibrate_latency()
    assert result.num_samples == 6
    assert 4.0 <= result.mean_latency_ms <= 30.0
    assert result.recommended_max_latency_ms >= result.mean_latency_ms
    lo, hi = result.confidence_interval_ms
    assert lo <= result.mean_latency_ms <= hi
    assert result.quality in ("excellent", "good", "acceptable")
    report = cal.get_calibration_report()
    assert report["status"] == "calibrated"


def test_latency_calibration_timeout_gives_poor():
    class DeadAdapter:
        def send_test_command(self, cmd):
            pass

        def get_response_state(self):
            return {"throttle": 0.0}

    cal = MotorLatencyCalibrator(
        DeadAdapter(),
        config={"num_samples": 2, "timeout_s": 0.02, "settle_time_s": 0.0},
    )
    result = cal.calibrate_latency()
    assert result.num_samples == 0
    assert result.quality == "poor"


@pytest.mark.parametrize("latencies", [[5.0], [4.1, 4.3, 4.2, 4.0, 4.4],
                                       [3.0, 9.0, 30.0, 12.0, 5.5, 61.0, 7.5]])
def test_latency_analysis_matches_jax(latencies):
    """The statistics, budget and grade on the same measurements, exactly."""
    config = {"num_samples": 6}
    port = MotorLatencyCalibrator(None, config)
    jax_cal = J_calibration.MotorLatencyCalibrator(None, config)
    port.measurements = [LatencyMeasurement(i, "throttle", x, 0.0)
                         for i, x in enumerate(latencies)]
    jax_cal.measurements = [J_calibration.LatencyMeasurement(i, "throttle", x, 0.0)
                            for i, x in enumerate(latencies)]
    assert port.get_calibration_report() == jax_cal.get_calibration_report()


# ----------------------------------------------------- secure channel

@pytest.fixture
def secure_env():
    auth = AuthManager()
    auth.register_user("op", "pw-op-123", Role.OPERATOR)
    auth.register_user("watch", "pw-watch-1", Role.VIEWER)
    op_token = auth.create_access_token(auth.authenticate("op", "pw-op-123"))
    view_token = auth.create_access_token(auth.authenticate("watch", "pw-watch-1"))
    shi = SecureHardwareInterface(SimulatedVehicleIO(device="cpu"), auth)
    return shi, op_token, view_token


def test_secure_command_permissions(secure_env):
    shi, op_token, view_token = secure_env
    run(shi.connect(op_token))
    assert shi.state == ConnectionState.CONNECTED
    assert run(shi.send_secure_command(op_token, "arm"))
    with pytest.raises(SecurityError):
        run(shi.send_secure_command(view_token, "arm"))
    with pytest.raises(UnsupportedCommandError):
        run(shi.send_secure_command(op_token, "warp_drive"))
    log = shi.get_command_audit_log(op_token)
    statuses = [(e["command_type"], e["status"]) for e in log]
    assert ("arm", "executed") in statuses
    assert ("arm", "denied") in statuses


def test_emergency_stop_blocks_until_reauth(secure_env):
    shi, op_token, view_token = secure_env
    run(shi.connect(op_token))
    # viewers may trigger the stop
    assert run(shi.emergency_stop(view_token))
    assert shi.get_connection_status()["emergency_stop_engaged"]
    with pytest.raises(SecurityError):
        run(shi.send_secure_command(op_token, "takeoff"))
    # disengage requires operator re-auth with valid password
    with pytest.raises(SecurityError):
        shi.disengage_emergency_stop(op_token, "op", "wrong")
    assert shi.disengage_emergency_stop(op_token, "op", "pw-op-123")
    assert shi.state == ConnectionState.CONNECTED
    assert run(shi.send_secure_command(op_token, "arm"))


def test_secure_telemetry(secure_env):
    shi, op_token, view_token = secure_env
    run(shi.connect(view_token))
    tele = shi.get_secure_telemetry(view_token)
    assert tele["connection_state"] == "connected"
    assert tele["emergency_stop_engaged"] is False


def test_estop_latches_via_send_secure_command(secure_env):
    """emergency_stop through the generic command channel must latch the
    software estop exactly like the dedicated method."""
    shi, op_token, _ = secure_env
    run(shi.connect(op_token))
    assert run(shi.send_secure_command(op_token, "emergency_stop"))
    assert shi.get_connection_status()["emergency_stop_engaged"]
    with pytest.raises(SecurityError):
        run(shi.send_secure_command(op_token, "arm"))


def test_secure_channel_takes_a_token_the_jax_package_signed():
    """One keypair, two packages: the JAX package's operator token arms
    the port's vehicle, its viewer token is refused and audited."""
    jax_auth = JAuthManager()
    port_auth = AuthManager(jax_auth._private.private_bytes(*_pem_args()))
    op = jax_auth.create_access_token(jax_auth.register_user("op", "pw-op-123", JRole.OPERATOR))
    vw = jax_auth.create_access_token(jax_auth.register_user("vw", "pw-vw-123", JRole.VIEWER))
    shi = SecureHardwareInterface(SimulatedVehicleIO(device="cpu"), port_auth)
    run(shi.connect(op))
    assert run(shi.send_secure_command(op, "arm"))
    with pytest.raises(SecurityError):
        run(shi.send_secure_command(vw, "arm"))
    assert ("arm", "denied") in [(e["command_type"], e["status"])
                                 for e in shi.get_command_audit_log(op)]


def _pem_args():
    from cryptography.hazmat.primitives import serialization

    return (serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption())


# -------------------------------------------------------- mixing schema

BAD_MIXING = [
    {"motor_directions": [1, 1, 1, -1]},          # unbalanced yaw
    {"motor_directions": [1, -1, 2, -1]},          # not +-1
    {"motor_positions": [[0.1, 0.1, 0.0]] * 3},    # only 3 motors
    {"pwm_min": 0.5, "pwm_idle": 0.4},             # idle below min
    {"pwm_idle": 1.0},                             # idle not < max
    # collinear motors: roll/pitch/yaw not independently controllable
    {"motor_positions": [[0.15, 0.0, 0.0], [-0.15, 0.0, 0.0],
                         [0.3, 0.0, 0.0], [-0.3, 0.0, 0.0]]},
]


def test_mixing_schema_accepts_defaults_and_builds_config():
    cfg = validate_motor_mixing({})
    assert len(cfg.motor_positions) == 4
    m = MotorMixingModel(arm_length=0.2, pwm_idle=0.05)
    assert m.to_config().arm_length == 0.2


@pytest.mark.parametrize("bad", BAD_MIXING)
def test_mixing_schema_rejects_bad_configs(bad):
    with pytest.raises(Exception):
        validate_motor_mixing(bad)


def _errors(fn, raw):
    try:
        fn(raw)
    except Exception as e:  # pydantic's ValidationError, from either package
        return [(err["loc"], err["msg"], err["type"]) for err in e.errors()]
    raise AssertionError(f"{raw} accepted")


@pytest.mark.parametrize("raw", [{}, {"arm_length": 0.2, "pwm_idle": 0.05},
                                 {"motor_directions": [-1, 1, -1, 1], "pwm_max": 0.9,
                                  "yaw_torque_coefficient": 0.02}])
def test_mixing_schema_config_matches_jax(raw):
    port, jax_cfg = validate_motor_mixing(raw), J_mixing.validate_motor_mixing(raw)
    assert vars(port) == vars(jax_cfg)


@pytest.mark.parametrize("bad", BAD_MIXING)
def test_mixing_schema_errors_match_jax(bad):
    assert _errors(validate_motor_mixing, bad) == _errors(J_mixing.validate_motor_mixing, bad)
