"""Thread-safe versioned state buffers (PyTorch counterpart of
:mod:`dart_planner_tpu.common.state_buffer`).

Host-side copy of the reference ``ThreadSafeStateBuffer`` (its
common/state_buffer.py:37-268): a versioned ring buffer bridging
asynchronous producers (estimator thread, device-to-host streams) and
consumers (control loop, telemetry). States (the port's ``DroneState``
etc.) are stored by reference, on whatever device they live, without
copies.
"""

from __future__ import annotations

import asyncio
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Generic, List, Optional, TypeVar

from dart_planner_tpu_torch.common.device import to_host
from dart_planner_tpu_torch.common.types import DroneState, EstimatedState

T = TypeVar("T")


@dataclass
class StateSnapshot(Generic[T]):
    """Versioned, timestamped state (reference state_buffer.py:29-35)."""

    state: T
    version: int
    timestamp: float
    source: str = "unknown"


class ThreadSafeStateBuffer(Generic[T]):
    """Versioned ring buffer with latest/at-time queries and asyncio
    subscriptions (reference state_buffer.py:37-268)."""

    def __init__(self, buffer_size: int = 10, state_type: type = DroneState):
        self.buffer_size = buffer_size
        self.state_type = state_type
        self._ring: List[Optional[StateSnapshot[T]]] = [None] * buffer_size
        self._version = 0
        self._lock = threading.RLock()
        self._update_event = threading.Event()
        self._subscribers: List[asyncio.Queue] = []
        self._stats = {"updates": 0, "queries": 0, "dropped_notifications": 0}

    def update_state(
        self, state: T, source: str = "unknown", timestamp: Optional[float] = None
    ) -> int:
        """Insert a new state; returns its version (reference :74-111)."""
        with self._lock:
            self._version += 1
            snap = StateSnapshot(
                state=state,
                version=self._version,
                timestamp=timestamp if timestamp is not None else time.time(),
                source=source,
            )
            self._ring[self._version % self.buffer_size] = snap
            self._stats["updates"] += 1
            version = self._version
        self._update_event.set()
        self._notify_subscribers(snap)
        return version

    def get_latest_state(self) -> Optional[StateSnapshot[T]]:
        """(reference :113-129)"""
        with self._lock:
            self._stats["queries"] += 1
            if self._version == 0:
                return None
            return self._ring[self._version % self.buffer_size]

    def get_state_at_time(
        self, target_time: float, tolerance: float = 0.1
    ) -> Optional[StateSnapshot[T]]:
        """Closest stored snapshot within ``tolerance`` (reference :131-152)."""
        with self._lock:
            self._stats["queries"] += 1
            best = None
            best_dt = tolerance
            for snap in self._ring:
                if snap is None:
                    continue
                dt = abs(snap.timestamp - target_time)
                if dt <= best_dt:
                    best, best_dt = snap, dt
            return best

    def wait_for_update(self, timeout: float = 1.0) -> Optional[StateSnapshot[T]]:
        """Block until the next update (reference :154-173)."""
        self._update_event.clear()
        if self._update_event.wait(timeout):
            return self.get_latest_state()
        return None

    async def wait_for_update_async(
        self, timeout: float = 1.0
    ) -> Optional[StateSnapshot[T]]:
        """(reference :175-190)"""
        loop = asyncio.get_event_loop()
        return await loop.run_in_executor(None, self.wait_for_update, timeout)

    def subscribe(self, queue_size: int = 10) -> asyncio.Queue:
        """(reference :192-204)"""
        q: asyncio.Queue = asyncio.Queue(maxsize=queue_size)
        with self._lock:
            self._subscribers.append(q)
        return q

    def unsubscribe(self, queue: asyncio.Queue) -> None:
        with self._lock:
            if queue in self._subscribers:
                self._subscribers.remove(queue)

    def _notify_subscribers(self, snap: StateSnapshot[T]) -> None:
        with self._lock:
            subs = list(self._subscribers)
        for q in subs:
            try:
                q.put_nowait(snap)
            except asyncio.QueueFull:
                self._stats["dropped_notifications"] += 1

    def get_statistics(self) -> Dict[str, Any]:
        with self._lock:
            return {
                **self._stats,
                "current_version": self._version,
                "buffer_size": self.buffer_size,
                "subscribers": len(self._subscribers),
            }

    def reset(self) -> None:
        with self._lock:
            self._ring = [None] * self.buffer_size
            self._version = 0
            for k in self._stats:
                self._stats[k] = 0


class DroneStateBuffer(ThreadSafeStateBuffer[DroneState]):
    """(reference :271-292)"""

    def __init__(self, buffer_size: int = 10):
        super().__init__(buffer_size, DroneState)

    def update_from_estimator(
        self, estimated_state: EstimatedState, source: str = "estimator"
    ) -> int:
        return self.update_state(
            estimated_state.to_drone_state(),
            source=source,
            timestamp=float(to_host(estimated_state.timestamp)),
        )


class StateManager:
    """Named-buffer registry (reference :306-355)."""

    def __init__(self):
        self._buffers: Dict[str, ThreadSafeStateBuffer] = {}
        self._lock = threading.RLock()

    def register_buffer(self, name: str, buffer: ThreadSafeStateBuffer) -> None:
        with self._lock:
            self._buffers[name] = buffer

    def get_buffer(self, name: str) -> Optional[ThreadSafeStateBuffer]:
        with self._lock:
            return self._buffers.get(name)

    def update_state(self, buffer_name: str, state, **kw) -> Optional[int]:
        buf = self.get_buffer(buffer_name)
        return buf.update_state(state, **kw) if buf else None

    def get_latest_state(self, buffer_name: str) -> Optional[StateSnapshot]:
        buf = self.get_buffer(buffer_name)
        return buf.get_latest_state() if buf else None

    def get_all_statistics(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {n: b.get_statistics() for n, b in self._buffers.items()}

    def reset_all(self) -> None:
        with self._lock:
            for b in self._buffers.values():
                b.reset()


def create_drone_state_buffer(buffer_size: int = 10) -> DroneStateBuffer:
    return DroneStateBuffer(buffer_size)


def create_state_manager() -> StateManager:
    return StateManager()
