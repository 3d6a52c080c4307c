"""ZMQ REQ/REP transport (PyTorch counterpart of
:mod:`dart_planner_tpu.comms.zmq_transport`, the same protocol on the
wire).

Port of the reference ``ZmqServer``/``ZmqClient``
(the reference's communication/zmq_server.py:28-139,
zmq_client.py:28-148): REP socket with command->handler dispatch and
bind-address hardening, REQ client with poll timeout + auto-reconnect.
Payloads go through :class:`dart_planner_tpu_torch.comms.serializer`.

The request protocol is kept apart from the sockets: a
:class:`RequestHandler` takes a signed request's bytes and returns the
signed reply's bytes, and a :class:`RequestClient` signs a request, hands
its bytes to ``_exchange`` and verifies the reply. ``ZmqServer`` and
``ZmqClient`` carry those bytes over ZMQ. A ``RequestHandler`` used as it
is handles each request on the caller's thread, so a client whose
``_exchange`` calls its ``handle`` makes an in-process pair.
"""

from __future__ import annotations

import threading
import warnings
from typing import Any, Callable, Dict, Optional

from dart_planner_tpu_torch.common.errors import CommunicationError
from dart_planner_tpu_torch.comms.serializer import SecureSerializer

try:
    import zmq

    _HAS_ZMQ = True
except ImportError:  # pragma: no cover - zmq is present in CI
    _HAS_ZMQ = False


def _require_zmq():
    if not _HAS_ZMQ:
        raise CommunicationError("pyzmq is not installed")


class RequestHandler:
    """The server side of the protocol without a socket: command ->
    handler dispatch over signed bytes (reference zmq_server.py:54-62,
    :82-85 and :113-139)."""

    def __init__(self, serializer: Optional[SecureSerializer] = None):
        self.serializer = serializer or SecureSerializer(test_mode=True)
        self._handlers: Dict[str, Callable[[Any], Any]] = {}

    def add_handler(self, command: str, handler: Callable[[Any], Any]) -> None:
        """(reference :54-62)"""
        self._handlers[command] = handler

    def start(self) -> None:
        """Without a socket, requests are handled on the caller's thread:
        nothing to start."""

    def stop(self) -> None:
        """Nothing to stop without a socket."""

    def handle(self, raw: bytes) -> bytes:
        """A signed request in, the signed reply out; a failure of the
        request or of its handler becomes an error reply."""
        try:
            reply = self._dispatch(raw)
        except Exception as e:  # never kill the serving loop
            reply = {"status": "error", "message": str(e)}
        return self.serializer.serialize(reply)

    def _dispatch(self, raw: bytes) -> Any:
        """command -> handler (reference :113-139)."""
        request = self.serializer.deserialize(raw)
        command = (
            request.get("command") if isinstance(request, dict) else None
        )
        handler = self._handlers.get(command)
        if handler is None:
            return {"status": "error", "message": f"unknown command {command!r}"}
        result = handler(request.get("data"))
        return {"status": "ok", "result": result}


class ZmqServer(RequestHandler):
    """(reference zmq_server.py:28-139)"""

    def __init__(
        self,
        port: int = 5555,
        bind_address: str = "127.0.0.1",
        serializer: Optional[SecureSerializer] = None,
    ):
        _require_zmq()
        if bind_address == "0.0.0.0":
            warnings.warn(
                "binding ZMQ to 0.0.0.0 exposes the control channel to all "
                "interfaces (reference zmq_server.py:38-52)",
                stacklevel=2,
            )
        super().__init__(serializer)
        self.port = port
        self.bind_address = bind_address
        self._ctx = zmq.Context.instance()
        self._sock = self._ctx.socket(zmq.REP)
        self._sock.bind(f"tcp://{bind_address}:{port}")
        self._running = False
        self._thread: Optional[threading.Thread] = None

    def start(self, daemon: bool = True) -> None:
        """Serve requests on a daemon thread (reference :64-82)."""
        self._running = True
        self._thread = threading.Thread(target=self._serve, daemon=daemon)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self._sock.close(0)

    def _serve(self) -> None:
        poller = zmq.Poller()
        poller.register(self._sock, zmq.POLLIN)
        while self._running:
            if not dict(poller.poll(timeout=100)):
                continue
            self._sock.send(self.handle(self._sock.recv()))


class RequestClient:
    """The client side of the protocol without a socket: signs a request,
    passes its bytes to :meth:`_exchange` and verifies the reply
    (reference zmq_client.py:62-101)."""

    def __init__(self, serializer: Optional[SecureSerializer] = None):
        self.serializer = serializer or SecureSerializer(test_mode=True)

    def send_request(self, command: str, data: Any = None) -> Any:
        payload = self.serializer.serialize({"command": command, "data": data})
        reply = self.serializer.deserialize(self._exchange(command, payload))
        if isinstance(reply, dict) and reply.get("status") == "error":
            raise CommunicationError(reply.get("message", "remote error"))
        return reply.get("result") if isinstance(reply, dict) else reply

    def _exchange(self, command: str, payload: bytes) -> bytes:
        """The reply's bytes to the request ``payload``; raises
        ``CommunicationError`` when none comes."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class ZmqClient(RequestClient):
    """(reference zmq_client.py:28-148)"""

    def __init__(
        self,
        host: str = "localhost",
        port: int = 5555,
        timeout_ms: int = 1000,
        serializer: Optional[SecureSerializer] = None,
    ):
        _require_zmq()
        super().__init__(serializer)
        self.host = host
        self.port = port
        self.timeout_ms = timeout_ms
        self._ctx = zmq.Context.instance()
        self._sock: Optional[zmq.Socket] = None
        self._connect()

    def _connect(self) -> None:
        if self._sock is not None:
            self._sock.close(0)
        self._sock = self._ctx.socket(zmq.REQ)
        self._sock.connect(f"tcp://{self.host}:{self.port}")

    def _exchange(self, command: str, payload: bytes) -> bytes:
        """REQ with poll timeout + auto-reconnect (reference :62-101)."""
        self._sock.send(payload)
        if not self._sock.poll(self.timeout_ms, zmq.POLLIN):
            # REQ socket is now stuck; rebuild it (reference reconnect)
            self._connect()
            raise CommunicationError(
                f"request {command!r} timed out after {self.timeout_ms} ms"
            )
        return self._sock.recv()

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close(0)
            self._sock = None
