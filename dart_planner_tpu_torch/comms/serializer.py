"""Pickle-free signed serialization (PyTorch counterpart of
:mod:`dart_planner_tpu.comms.serializer`, with the same wire format).

Port of the reference ``SecureSerializer``
(the reference's communication/secure_serializer.py): JSON payloads signed
with HMAC-SHA256 over ``data:timestamp:message_id`` (:77-90), TTL
validation (default 300 s, :62-69), numpy round-tripping under the
``__ndarray__`` tag (:181-226), secret from ``DART_ZMQ_SECRET`` with a
random secret in test mode (:48-59). A message signed by either package
verifies in the other under the same secret.

A ``torch.Tensor`` in a payload goes on the wire as the numpy array of its
host copy (:func:`~dart_planner_tpu_torch.common.device.to_host`, its
dtype kept); decoding gives numpy arrays, as in the JAX package.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
import secrets as _secrets
import time
from typing import Any, Optional

import numpy as np
import torch

from dart_planner_tpu_torch.common.device import to_host
from dart_planner_tpu_torch.common.errors import CommunicationError, SecurityError

_NDARRAY_TAG = "__ndarray__"


def _encode_numpy(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        obj = to_host(obj, dtype=None)  # a host copy, its dtype kept
    if isinstance(obj, np.ndarray):
        return {
            _NDARRAY_TAG: obj.tolist(),
            "dtype": str(obj.dtype),
            "shape": list(obj.shape),
        }
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, dict):
        return {k: _encode_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_encode_numpy(v) for v in obj]
    return obj


def _decode_numpy(obj: Any) -> Any:
    if isinstance(obj, dict):
        if _NDARRAY_TAG in obj:
            return np.asarray(obj[_NDARRAY_TAG], dtype=obj["dtype"]).reshape(
                obj["shape"]
            )
        return {k: _decode_numpy(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode_numpy(v) for v in obj]
    return obj


class SecureSerializer:
    """(reference secure_serializer.py:40-248)"""

    def __init__(
        self,
        secret_key: Optional[str] = None,
        test_mode: bool = False,
        message_ttl: Optional[int] = None,
    ):
        env_secret = os.getenv("DART_ZMQ_SECRET")
        env_mode = os.getenv("DART_ENVIRONMENT", "development")
        self._test_mode = test_mode or env_mode in ("test", "testing")
        if secret_key:
            self.secret_key = secret_key
        elif env_secret:
            self.secret_key = env_secret
        elif self._test_mode:
            self.secret_key = _secrets.token_urlsafe(32)
        else:
            raise SecurityError(
                "DART_ZMQ_SECRET must be set in non-test environments"
            )
        self._counter = 0
        env_ttl = os.getenv("DART_MSG_TTL")
        self._ttl = (
            message_ttl
            if message_ttl is not None
            else (int(env_ttl) if env_ttl and env_ttl.isdigit() else 300)
        )

    def _sign(self, data: str, timestamp: float, message_id: str) -> str:
        msg = f"{data}:{timestamp}:{message_id}"
        return hmac.new(
            self.secret_key.encode(), msg.encode(), hashlib.sha256
        ).hexdigest()

    def serialize(self, obj: Any) -> bytes:
        """JSON + HMAC envelope (reference :93-135)."""
        self._counter += 1
        message_id = f"msg_{self._counter}_{os.getpid()}"
        timestamp = time.time()
        payload = _encode_numpy(obj)
        data_json = json.dumps(payload)
        envelope = {
            "data": payload,
            "signature": self._sign(data_json, timestamp, message_id),
            "timestamp": timestamp,
            "message_id": message_id,
        }
        return json.dumps(envelope).encode()

    def deserialize(self, raw: bytes) -> Any:
        """Verify signature + TTL, decode (reference :137-179)."""
        try:
            envelope = json.loads(raw.decode())
        except (ValueError, UnicodeDecodeError) as e:
            raise CommunicationError(f"malformed message: {e}") from e
        for key in ("data", "signature", "timestamp", "message_id"):
            if key not in envelope:
                raise CommunicationError(f"missing envelope field {key}")
        if time.time() - envelope["timestamp"] > self._ttl:
            raise SecurityError("message expired (TTL)")
        data_json = json.dumps(envelope["data"])
        expected = self._sign(
            data_json, envelope["timestamp"], envelope["message_id"]
        )
        if not hmac.compare_digest(expected, envelope["signature"]):
            raise SecurityError("message signature verification failed")
        return _decode_numpy(envelope["data"])


_default: Optional[SecureSerializer] = None


def _get_default() -> SecureSerializer:
    global _default
    if _default is None:
        _default = SecureSerializer()
    return _default


def serialize(obj: Any) -> bytes:
    """Module-level helper (reference :249-252)."""
    return _get_default().serialize(obj)


def deserialize(raw: bytes) -> Any:
    """Module-level helper (reference :254-257)."""
    return _get_default().deserialize(raw)
