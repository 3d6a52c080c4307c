"""Transport-delay replay buffer (PyTorch counterpart of
:mod:`dart_planner_tpu.hardware.latency_buffer`).

A framework-free copy of the reference ``utils/latency_buffer.py``
(:34-116): a fixed-size ring that returns data from ``delay_s`` ago, used
to emulate the 25 ms estimator->controller transport delay
(``config/hardware.yaml``'s transport_delay block) during SITL testing.
Items are stored by reference: a tensor stays where it is.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Generic, Optional, TypeVar

T = TypeVar("T")


class LatencyBuffer(Generic[T]):
    """(reference latency_buffer.py:34-116)"""

    def __init__(self, delay_s: float, dt: float, max_buffer_size: int = 1000):
        self.delay_s = delay_s
        self.dt = dt
        self.required_size = max(1, int(round(delay_s / dt)))
        self.buffer_size = min(self.required_size, max_buffer_size)
        self.buffer: deque = deque(maxlen=self.buffer_size)
        self.last_output: Optional[T] = None
        self.last_timestamp = 0.0
        self.total_samples = 0
        self.missed_samples = 0
        self.actual_delay_s = 0.0

    def push(self, data: T, timestamp: Optional[float] = None) -> T:
        """Push current data, get data from ``delay_s`` ago (or current
        while the ring fills)."""
        if timestamp is None:
            timestamp = time.time()
        self.total_samples += 1
        if len(self.buffer) < self.buffer_size:
            self.buffer.append((timestamp, data))
            self.missed_samples += 1
            return data
        delayed_ts, delayed = self.buffer.popleft()
        self.buffer.append((timestamp, data))
        self.last_output = delayed
        self.last_timestamp = delayed_ts
        self.actual_delay_s = timestamp - delayed_ts
        return delayed

    def get_delayed_data(self) -> Optional[T]:
        return self.last_output

    def get_actual_delay(self) -> float:
        return self.actual_delay_s

    def is_ready(self) -> bool:
        return len(self.buffer) >= self.buffer_size

    def get_statistics(self) -> dict:
        return {
            "requested_delay_s": self.delay_s,
            "actual_delay_s": self.actual_delay_s,
            "buffer_size": len(self.buffer),
            "required_size": self.required_size,
            "total_samples": self.total_samples,
            "missed_samples": self.missed_samples,
        }

    def reset(self) -> None:
        self.buffer.clear()
        self.last_output = None
        self.last_timestamp = 0.0
        self.total_samples = 0
        self.missed_samples = 0
        self.actual_delay_s = 0.0
