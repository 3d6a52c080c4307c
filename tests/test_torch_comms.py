"""The port's edge<->cloud boundary (``dart_planner_tpu_torch.comms``) and
``common/timing.py``, against the JAX package.

The cases of tests/test_comms.py run against the port (real ZMQ sockets on
localhost, each on a port the OS assigns). Wire parity with the JAX
package, on the same inputs:

- a message signed by either package's ``SecureSerializer`` verifies in
  the other under the same secret, and decodes to equal values; a numpy
  array and a CPU tensor encode to the JAX package's JSON text exactly;
- a tampered, expired or cross-key message is refused by both;
- a ZMQ request from either package is answered by the other's server;
- telemetry packets compress to the same bytes in every mode (the clock
  fixed, since gzip and zip headers carry it) and decompress across the
  packages (arrays exactly);
- ``TimingManager`` gives the JAX package's decisions and statistics on
  the same injected call sequence (exactly: the same float64 arithmetic).
"""

import asyncio
import json
import socket
import time

import numpy as np
import pytest
import torch

from dart_planner_tpu.common import timing as J_timing
from dart_planner_tpu.comms import serializer as J_ser
from dart_planner_tpu.comms import telemetry as J_tel
from dart_planner_tpu.comms import zmq_transport as J_zmq
from dart_planner_tpu_torch import interop
from dart_planner_tpu_torch.common import timing
from dart_planner_tpu_torch.common.errors import CommunicationError, SecurityError
from dart_planner_tpu_torch.comms import (
    CompressionType,
    HeartbeatConfig,
    HeartbeatMessage,
    HeartbeatMonitor,
    SecureSerializer,
    TelemetryCompressor,
    ZmqClient,
    ZmqServer,
)
from dart_planner_tpu_torch.comms import serializer as T_ser
from dart_planner_tpu_torch.comms.zmq_transport import RequestClient, RequestHandler

KEY = "shared-test-key"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---- serializer (tests/test_comms.py) ----
def test_serializer_roundtrip_numpy():
    s = SecureSerializer(test_mode=True)
    obj = {
        "pos": np.array([1.0, 2.0, 3.0], np.float32),
        "traj": np.arange(12).reshape(4, 3),
        "label": "hello",
        "n": 7,
    }
    out = s.deserialize(s.serialize(obj))
    np.testing.assert_allclose(out["pos"], [1, 2, 3])
    assert out["traj"].shape == (4, 3) and out["traj"].dtype == np.int64
    assert out["label"] == "hello" and out["n"] == 7


def test_serializer_rejects_tampering():
    s = SecureSerializer(test_mode=True)
    raw = bytearray(s.serialize({"cmd": "land"}))
    idx = raw.find(b"land")
    raw[idx] = ord("x")
    with pytest.raises((SecurityError, CommunicationError)):
        s.deserialize(bytes(raw))


def test_serializer_rejects_cross_key():
    a = SecureSerializer(secret_key="key-a")
    b = SecureSerializer(secret_key="key-b")
    with pytest.raises(SecurityError):
        b.deserialize(a.serialize({"x": 1}))


def test_serializer_ttl_expiry():
    s = SecureSerializer(test_mode=True, message_ttl=0)
    raw = s.serialize({"x": 1})
    time.sleep(0.01)
    with pytest.raises(SecurityError):
        s.deserialize(raw)


def test_serializer_tensor_goes_through_the_host():
    """A tensor is encoded as its host copy, dtype kept; it decodes to
    numpy, as in the JAX package."""
    s = SecureSerializer(test_mode=True)
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    out = s.deserialize(s.serialize({"t": t, "b": torch.tensor([True, False])}))
    assert out["t"].dtype == np.float32 and out["t"].shape == (2, 3)
    np.testing.assert_array_equal(out["t"], t.numpy())
    assert out["b"].dtype == np.bool_ and out["b"].tolist() == [True, False]


# ---- wire parity with the JAX package ----
def _payload():
    rng = np.random.default_rng(0)
    return {
        "command": "update_state",
        "data": {
            "timestamp": 12.5,
            "position": rng.normal(size=3).astype(np.float32),
            "trajectory": rng.normal(size=(20, 3)).astype(np.float32),
            "ids": np.arange(4),
            "label": "nominal",
            "nested": [1, 2.5, {"k": np.float32(0.1)}],
        },
    }


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_messages_verify_across_packages(direction):
    js, ts = J_ser.SecureSerializer(secret_key=KEY), SecureSerializer(secret_key=KEY)
    signer, verifier = (js, ts) if direction == "jax_to_port" else (ts, js)
    out = verifier.deserialize(signer.serialize(_payload()))
    _assert_same(out, js.deserialize(js.serialize(_payload())))


def test_tensor_encodes_to_the_jax_text():
    """The signed text of a tensor payload is the JAX package's text of the
    same numpy array."""
    arr = np.random.default_rng(1).normal(size=(5, 3)).astype(np.float32)
    assert json.dumps(T_ser._encode_numpy({"a": torch.from_numpy(arr)})) == json.dumps(
        J_ser._encode_numpy({"a": arr})
    )
    assert json.dumps(T_ser._encode_numpy(_payload())) == json.dumps(
        J_ser._encode_numpy(_payload())
    )


@pytest.mark.parametrize("signer_pkg", ["jax", "port"])
@pytest.mark.parametrize("fault", ["tampered", "expired", "cross_key"])
def test_both_packages_refuse_bad_messages(signer_pkg, fault):
    mod = J_ser if signer_pkg == "jax" else T_ser
    signer = mod.SecureSerializer(secret_key="other" if fault == "cross_key" else KEY)
    raw = signer.serialize({"cmd": "land"})
    if fault == "tampered":
        raw = raw.replace(b"land", b"lanx")
    ttl = 0 if fault == "expired" else None
    if fault == "expired":
        time.sleep(0.01)
    for verifier in (J_ser.SecureSerializer(secret_key=KEY, message_ttl=ttl),
                     SecureSerializer(secret_key=KEY, message_ttl=ttl)):
        with pytest.raises(Exception) as e:
            verifier.deserialize(raw)
        assert type(e.value).__name__ == "SecurityError"


# ---- zmq (tests/test_comms.py) ----
def test_zmq_request_reply_roundtrip():
    port = _free_port()
    server = ZmqServer(port=port, serializer=SecureSerializer(secret_key=KEY))
    server.add_handler("echo", lambda data: {"echoed": data})
    server.add_handler("state", lambda data: {"pos": np.array([1.0, 2.0, 3.0])})
    server.start()
    try:
        client = ZmqClient(port=port, timeout_ms=2000,
                           serializer=SecureSerializer(secret_key=KEY))
        out = client.send_request("echo", {"v": 42})
        assert out == {"echoed": {"v": 42}}
        out2 = client.send_request("state")
        np.testing.assert_allclose(out2["pos"], [1, 2, 3])
        with pytest.raises(CommunicationError):
            client.send_request("nope")
        client.close()
    finally:
        server.stop()


def test_zmq_client_timeout_reconnects():
    client = ZmqClient(port=_free_port(), timeout_ms=200)  # nobody listening
    with pytest.raises(CommunicationError):
        client.send_request("ping")
    client.close()


@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_zmq_across_packages(server_pkg):
    """A JAX client asks a port server, and a port client a JAX server: the
    same request protocol on the wire."""
    port = _free_port()
    S, C = (J_zmq.ZmqServer, ZmqClient) if server_pkg == "jax" else (ZmqServer, J_zmq.ZmqClient)
    Ss = J_ser.SecureSerializer if server_pkg == "jax" else SecureSerializer
    Cs = SecureSerializer if server_pkg == "jax" else J_ser.SecureSerializer
    server = S(port=port, serializer=Ss(secret_key=KEY))
    server.add_handler("echo", lambda data: {"echoed": data})
    server.start()
    try:
        client = C(port=port, timeout_ms=5000, serializer=Cs(secret_key=KEY))
        arr = np.linspace(0, 1, 7, dtype=np.float32)
        out = client.send_request("echo", {"v": arr, "n": 3})
        assert out["echoed"]["n"] == 3 and out["echoed"]["v"].dtype == np.float32
        np.testing.assert_array_equal(out["echoed"]["v"], arr)
        with pytest.raises(Exception, match="unknown command"):
            client.send_request("nope")
        client.close()
    finally:
        server.stop()


def test_request_handling_without_a_socket():
    """The request protocol apart from the socket: signed bytes in, signed
    bytes out; a bad signature and an unknown command come back as error
    replies, and a failing handler does not stop the handler."""
    handler = RequestHandler(SecureSerializer(secret_key=KEY))
    handler.add_handler("echo", lambda data: {"echoed": data})
    handler.add_handler("boom", lambda data: 1 / 0)

    class InProcess(RequestClient):
        def _exchange(self, command, payload):
            return handler.handle(payload)

    client = InProcess(SecureSerializer(secret_key=KEY))
    assert client.send_request("echo", [1, 2]) == {"echoed": [1, 2]}
    with pytest.raises(CommunicationError, match="unknown command"):
        client.send_request("nope")
    with pytest.raises(CommunicationError, match="division by zero"):
        client.send_request("boom")
    bad = handler.handle(SecureSerializer(secret_key="wrong").serialize({"command": "echo"}))
    reply = SecureSerializer(secret_key=KEY).deserialize(bad)
    assert reply["status"] == "error" and "signature" in reply["message"]
    with pytest.raises(SecurityError):  # the reply is signed with the server's key
        InProcess(SecureSerializer(secret_key="wrong")).send_request("echo")
    reply = J_ser.SecureSerializer(secret_key=KEY).deserialize(
        handler.handle(J_ser.SecureSerializer(secret_key=KEY).serialize(
            {"command": "echo", "data": 5})))
    assert reply == {"status": "ok", "result": {"echoed": 5}}


# ---- heartbeat (tests/test_comms.py) ----
def test_heartbeat_triggers_emergency_on_loss():
    events = []

    async def main():
        mon = HeartbeatMonitor(
            HeartbeatConfig(interval_ms=20, timeout_ms=80),
            emergency_callback=lambda: events.append("emergency"),
        )
        mon.start_monitoring()
        for _ in range(5):
            await asyncio.sleep(0.02)
            await mon.heartbeat_received()
        assert not mon.emergency_triggered
        await asyncio.sleep(0.3)
        mon.stop_monitoring()
        return mon

    mon = asyncio.run(main())
    assert mon.emergency_triggered
    assert events == ["emergency"]
    assert mon.get_status()["emergency_triggered"]


def test_heartbeat_message_and_config_match_jax():
    from dart_planner_tpu.comms import heartbeat as J_hb

    msg = HeartbeatMessage("edge-1", timestamp=12.5)
    assert msg.to_dict() == J_hb.HeartbeatMessage("edge-1", timestamp=12.5).to_dict()
    back = J_hb.HeartbeatMessage.from_dict(msg.to_dict())
    assert (back.sender_id, back.timestamp) == ("edge-1", 12.5)
    assert vars(HeartbeatConfig()) == vars(J_hb.HeartbeatConfig())


# ---- telemetry (tests/test_comms.py) ----
def test_telemetry_roundtrip_all_modes():
    tc = TelemetryCompressor()
    data = {
        "positions": np.random.rand(50, 3).astype(np.float32),
        "mode": "NOMINAL",
        "battery": 11.1,
    }
    for mode in CompressionType:
        pkt = tc.compress_telemetry(data, mode)
        out = tc.decompress_telemetry(pkt)
        np.testing.assert_allclose(np.asarray(out["positions"]), data["positions"], atol=1e-6)
        assert out["mode"] == "NOMINAL"
    stats = tc.get_compression_stats()
    assert stats["packets"] == len(CompressionType)


def test_telemetry_gzip_compresses_redundant_data():
    tc = TelemetryCompressor()
    data = {"zeros": np.zeros((1000, 3))}
    pkt = tc.compress_telemetry(data, CompressionType.BINARY_GZIP)
    assert pkt.compression_ratio > 5.0


def _telemetry():
    rng = np.random.default_rng(2)
    return {
        "positions": rng.normal(size=(50, 3)).astype(np.float32),
        "tier": "nominal",
        "battery": 11.1,
        "count": 7,
    }


@pytest.mark.parametrize("mode", [m.value for m in CompressionType])
def test_telemetry_bytes_match_jax(mode, monkeypatch):
    """The same packet compresses to the same bytes in both packages (the
    clock fixed: gzip's and the zip entries' headers carry it); a tensor
    field packs as its numpy array."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    data = _telemetry()
    jp = J_tel.TelemetryCompressor().compress_telemetry(data, J_tel.CompressionType(mode))
    tp = TelemetryCompressor().compress_telemetry(data, CompressionType(mode))
    tt = TelemetryCompressor().compress_telemetry(
        {**data, "positions": torch.from_numpy(data["positions"])}, CompressionType(mode))
    assert tp.payload == jp.payload == tt.payload
    # the packet's own timestamp is its creation time
    assert {**tp.to_dict(), "timestamp": 0} == {**jp.to_dict(), "timestamp": 0}


@pytest.mark.parametrize("mode", [m.value for m in CompressionType])
def test_telemetry_decompresses_across_packages(mode):
    data = _telemetry()
    jc, tc = J_tel.TelemetryCompressor(), TelemetryCompressor()
    from_jax = tc.decompress_telemetry(
        interop.telemetry_packet_from_jax(jc.compress_telemetry(data, J_tel.CompressionType(mode))))
    tp = tc.compress_telemetry(data, CompressionType(mode))
    from_port = jc.decompress_telemetry(J_tel.TelemetryPacket(
        J_tel.CompressionType(tp.compression.value), tp.payload, tp.timestamp,
        tp.original_size, tp.compressed_size))
    for out in (from_jax, from_port):
        np.testing.assert_array_equal(np.asarray(out["positions"], np.float32), data["positions"])
        assert (out["tier"], out["battery"], out["count"]) == ("nominal", 11.1, 7)


# ---- common/timing.py ----
def _timing_trace(mod):
    """Decisions and statistics of a TimingManager under one injected call
    sequence (throttled and unthrottled)."""
    out = []
    for throttle in (True, False):
        tm = mod.TimingManager(mod.TimingConfig(
            control_frequency=400.0, planning_frequency=50.0,
            max_planning_latency=0.02, enable_throttling=throttle))
        out.append(tm.get_planner_dt())
        rng = np.random.default_rng(3)
        t = 0.0
        for k in range(400):
            t += float(rng.uniform(0.0005, 0.004))
            out.append(tm.should_control(t))
            tm.update_control_timing(t)
            if k % 7 == 0:
                out.append(tm.should_plan(t))
                tm.update_planning_timing(t, float(rng.uniform(0.001, 0.04)))
        out.append(tm.get_timing_stats())
        tm.reset_stats()
        out.append(tm.get_timing_stats())
    return out


def test_timing_manager_matches_jax():
    assert _timing_trace(timing) == _timing_trace(J_timing)
    cfg = timing.TimingConfig()
    assert (cfg.control_frequency, cfg.planning_frequency, cfg.mode.value) == (
        400.0, 50.0, J_timing.TimingConfig().mode.value)
    assert timing.get_timing_manager(timing.TimingConfig(control_frequency=100.0)).control_dt == 0.01


def test_high_res_sleep_waits_at_least_its_duration():
    for d in (0.0, 0.0003, 0.002):
        t0 = time.perf_counter()
        timing.high_res_sleep(d)
        assert time.perf_counter() - t0 >= d

