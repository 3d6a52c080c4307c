"""Telemetry compression (PyTorch counterpart of
:mod:`dart_planner_tpu.comms.telemetry`: the same bytes for the same
packet in every mode).

Port of the reference ``TelemetryCompressor``
(the reference's communication/telemetry_compression.py): gzip /
binary-struct packet encodings with a compression-type enum (:21-49) and
compress/decompress round-trip (:89-177). The binary format packs numpy
arrays natively (dtype+shape header) instead of the reference's
field-by-field struct packing — same wire-size benefit, simpler and
shape-generic. A ``torch.Tensor`` field is packed as the numpy array of
its host copy (dtype kept); decompression gives numpy arrays.
"""

from __future__ import annotations

import gzip
import io
import json
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict

import numpy as np
import torch

from dart_planner_tpu_torch.common.device import to_host


class CompressionType(Enum):
    """(reference telemetry_compression.py:21-27)"""

    NONE = "none"
    GZIP = "gzip"
    BINARY = "binary"
    BINARY_GZIP = "binary_gzip"


@dataclass
class TelemetryPacket:
    """(reference telemetry_compression.py:30-47)"""

    compression: CompressionType
    payload: bytes
    timestamp: float = field(default_factory=time.time)
    original_size: int = 0
    compressed_size: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "compression": self.compression.value,
            "timestamp": self.timestamp,
            "original_size": self.original_size,
            "compressed_size": self.compressed_size,
        }

    @property
    def compression_ratio(self) -> float:
        return self.original_size / max(self.compressed_size, 1)


def _host(v: Any) -> Any:
    """A tensor as the numpy array of its host copy, its dtype kept."""
    return to_host(v, dtype=None) if isinstance(v, torch.Tensor) else v


def _to_binary(data: Dict[str, Any]) -> bytes:
    """numpy-native binary packing (replaces reference struct packing)."""
    buf = io.BytesIO()
    arrays = {}
    plain = {}
    for k, v in data.items():
        v = _host(v)
        if isinstance(v, np.ndarray):
            arrays[k] = v
        else:
            plain[k] = v
    np.savez(buf, __meta__=np.frombuffer(json.dumps(plain).encode(), np.uint8), **arrays)
    return buf.getvalue()


def _from_binary(raw: bytes) -> Dict[str, Any]:
    with np.load(io.BytesIO(raw)) as z:
        out: Dict[str, Any] = {}
        for k in z.files:
            if k == "__meta__":
                out.update(json.loads(z[k].tobytes().decode()))
            else:
                out[k] = z[k]
        return out


class TelemetryCompressor:
    """(reference telemetry_compression.py:49-300)"""

    def __init__(self, compression_level: int = 6, enable_binary: bool = True):
        self.compression_level = compression_level
        self.enable_binary = enable_binary
        self.stats = {"packets": 0, "bytes_in": 0, "bytes_out": 0}

    def compress_telemetry(
        self,
        data: Dict[str, Any],
        compression: CompressionType = CompressionType.BINARY_GZIP,
    ) -> TelemetryPacket:
        """(reference :89-149)"""
        if compression in (CompressionType.BINARY, CompressionType.BINARY_GZIP):
            raw = _to_binary(data)
        else:
            host = {k: _host(v) for k, v in data.items()}
            raw = json.dumps(
                {
                    k: v.tolist() if isinstance(v, np.ndarray) else v
                    for k, v in host.items()
                }
            ).encode()
        original = len(raw)
        if compression in (CompressionType.GZIP, CompressionType.BINARY_GZIP):
            payload = gzip.compress(raw, self.compression_level)
        else:
            payload = raw
        self.stats["packets"] += 1
        self.stats["bytes_in"] += original
        self.stats["bytes_out"] += len(payload)
        return TelemetryPacket(
            compression=compression,
            payload=payload,
            original_size=original,
            compressed_size=len(payload),
        )

    def decompress_telemetry(self, packet: TelemetryPacket) -> Dict[str, Any]:
        """(reference :151-177)"""
        raw = packet.payload
        if packet.compression in (
            CompressionType.GZIP,
            CompressionType.BINARY_GZIP,
        ):
            raw = gzip.decompress(raw)
        if packet.compression in (
            CompressionType.BINARY,
            CompressionType.BINARY_GZIP,
        ):
            return _from_binary(raw)
        return json.loads(raw.decode())

    def get_compression_stats(self) -> Dict[str, Any]:
        ratio = self.stats["bytes_in"] / max(self.stats["bytes_out"], 1)
        return {**self.stats, "overall_ratio": ratio}
