"""Heartbeat monitoring with emergency trigger.

A framework-free copy of :mod:`dart_planner_tpu.comms.heartbeat`: the port
keeps its own, since the JAX package cannot be imported without jax.

Port of the reference ``HeartbeatMonitor``
(the reference's communication/heartbeat.py): interval / timeout from
the central config (100 ms / 500 ms, the port's ``config/defaults.yaml``),
monitor loop that calls an emergency callback on loss (:80-104).
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Callable, Optional


@dataclass
class HeartbeatConfig:
    """(reference heartbeat.py:8-23)"""

    interval_ms: int = 100
    timeout_ms: int = 500
    mavlink_timeout_s: float = 5.0

    @classmethod
    def from_central_config(cls) -> "HeartbeatConfig":
        from dart_planner_tpu_torch.config import get_frozen_config

        comm = get_frozen_config().communication
        return cls(
            interval_ms=comm.heartbeat_interval_ms,
            timeout_ms=comm.heartbeat_timeout_ms,
        )


class HeartbeatMessage:
    """(reference heartbeat.py:116-134)"""

    def __init__(self, sender_id: str, timestamp: Optional[float] = None):
        self.sender_id = sender_id
        self.timestamp = timestamp if timestamp is not None else time.time()

    def to_dict(self) -> dict:
        return {
            "type": "heartbeat",
            "sender_id": self.sender_id,
            "timestamp": self.timestamp,
        }

    @classmethod
    def from_dict(cls, data: dict) -> "HeartbeatMessage":
        return cls(data["sender_id"], data.get("timestamp"))


class HeartbeatMonitor:
    """(reference heartbeat.py:25-114)"""

    def __init__(
        self,
        config: Optional[HeartbeatConfig] = None,
        emergency_callback: Optional[Callable[[], None]] = None,
    ):
        self.config = config or HeartbeatConfig()
        self.emergency_callback = emergency_callback
        self.last_received = 0.0
        self.last_sent = 0.0
        self.emergency_triggered = False
        self._task: Optional[asyncio.Task] = None
        self._running = False

    def start_monitoring(self) -> None:
        """(reference :40-53)"""
        self._running = True
        self.last_received = time.time()
        self.emergency_triggered = False
        self._task = asyncio.ensure_future(self._monitor_loop())

    def stop_monitoring(self) -> None:
        self._running = False
        if self._task is not None:
            self._task.cancel()
            self._task = None

    def heartbeat_received_sync(self) -> None:
        self.last_received = time.time()
        self.emergency_triggered = False

    def heartbeat_sent_sync(self) -> None:
        self.last_sent = time.time()

    async def heartbeat_received(self) -> None:
        self.heartbeat_received_sync()

    async def heartbeat_sent(self) -> None:
        self.heartbeat_sent_sync()

    async def _monitor_loop(self) -> None:
        """(reference :80-93)"""
        interval = self.config.interval_ms / 1000.0
        timeout = self.config.timeout_ms / 1000.0
        while self._running:
            await asyncio.sleep(interval)
            if (
                not self.emergency_triggered
                and time.time() - self.last_received > timeout
            ):
                self._trigger_emergency()

    def _trigger_emergency(self) -> None:
        """(reference :95-104)"""
        self.emergency_triggered = True
        if self.emergency_callback is not None:
            self.emergency_callback()

    def get_status(self) -> dict:
        """(reference :106-114)"""
        return {
            "last_received": self.last_received,
            "last_sent": self.last_sent,
            "emergency_triggered": self.emergency_triggered,
            "age_s": time.time() - self.last_received,
            "timeout_ms": self.config.timeout_ms,
        }
