"""Planner/controller timing alignment + precise host sleeping.

A framework-free copy of :mod:`dart_planner_tpu.common.timing` (host-side
numpy only): the port keeps its own, since the JAX package cannot be
imported without jax.

Host-side port of the reference ``TimingManager``
(the reference's common/timing_alignment.py:41-231) and
``high_res_sleep`` (common/timing_utils.py): planner dt is coupled to the
control frequency, planning/control are throttled to their rates, and
latency statistics mirror the reference field names so existing dashboards
keep working. The interpolation duty is
:mod:`dart_planner_tpu_torch.control.smoother`'s.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


class TimingMode(enum.Enum):
    """(reference timing_alignment.py:22-26)"""

    PLANNER_DRIVEN = "planner_driven"
    CONTROLLER_DRIVEN = "controller_driven"
    ADAPTIVE = "adaptive"


@dataclass
class TimingConfig:
    """(reference timing_alignment.py:29-38)"""

    control_frequency: float = 400.0  # Hz
    planning_frequency: float = 50.0  # Hz
    mode: TimingMode = TimingMode.ADAPTIVE
    max_planning_latency: float = 0.1  # s
    min_planning_interval: float = 0.01  # s
    enable_throttling: bool = True
    enable_interpolation: bool = True


@dataclass
class TimingManager:
    """(reference timing_alignment.py:41-231)"""

    config: TimingConfig = field(default_factory=TimingConfig)

    def __post_init__(self):
        self.control_dt = 1.0 / self.config.control_frequency
        self.planning_dt = 1.0 / self.config.planning_frequency
        self.last_plan_time = 0.0
        self.last_control_time = 0.0
        self.planning_latency = 0.0
        self.throttling_events = 0
        self.planning_times: List[float] = []
        self.control_times: List[float] = []

    def get_planner_dt(self) -> float:
        """Planner dt := control dt (reference :76-78) — the coupling the
        SE3MPCPlanner constructor consumes."""
        return self.control_dt

    def should_plan(self, current_time: float) -> bool:
        """(reference :80-99)"""
        if not self.config.enable_throttling:
            return True
        if current_time - self.last_plan_time < self.config.min_planning_interval:
            return False
        if self.planning_latency > self.config.max_planning_latency:
            self.throttling_events += 1
            return False
        self.last_plan_time = current_time
        return True

    def should_control(self, current_time: float) -> bool:
        """(reference :101-114)"""
        if not self.config.enable_throttling:
            return True
        if current_time - self.last_control_time >= self.control_dt:
            self.last_control_time = current_time
            return True
        return False

    def update_planning_timing(
        self, planning_time: float, planning_duration: float
    ) -> None:
        """(reference :116-124)"""
        self.last_plan_time = planning_time
        self.planning_latency = planning_duration
        self.planning_times.append(planning_duration)
        if len(self.planning_times) > 100:
            self.planning_times = self.planning_times[-100:]

    def update_control_timing(self, control_time: float) -> None:
        """(reference :126-139)"""
        delta = (
            control_time - self.last_control_time
            if self.last_control_time
            else self.control_dt
        )
        self.last_control_time = control_time
        self.control_times.append(delta)
        if len(self.control_times) > 1000:
            self.control_times = self.control_times[-1000:]

    def get_timing_stats(self) -> Dict[str, Any]:
        """(reference :209-223)"""
        stats: Dict[str, Any] = {
            "control_frequency": self.config.control_frequency,
            "planning_frequency": self.config.planning_frequency,
            "throttling_events": self.throttling_events,
            "planning_latency": self.planning_latency,
        }
        if self.planning_times:
            stats["mean_planning_time"] = float(np.mean(self.planning_times))
            stats["p95_planning_time"] = float(
                np.percentile(self.planning_times, 95)
            )
        if self.control_times:
            stats["mean_control_interval"] = float(np.mean(self.control_times))
        return stats

    def reset_stats(self) -> None:
        self.planning_times.clear()
        self.control_times.clear()
        self.throttling_events = 0


_timing_manager: Optional[TimingManager] = None


def get_timing_manager(config: Optional[TimingConfig] = None) -> TimingManager:
    """Module singleton (reference timing_alignment.py:284)."""
    global _timing_manager
    if _timing_manager is None or config is not None:
        _timing_manager = TimingManager(config or TimingConfig())
    return _timing_manager


def high_res_sleep(duration: float, spin_threshold: float = 0.0005) -> None:
    """Hybrid sleep/spin for sub-millisecond precision (reference
    common/timing_utils.py `high_res_sleep`): coarse ``time.sleep`` until
    ``spin_threshold`` remains, then busy-wait."""
    if duration <= 0:
        return
    deadline = time.perf_counter() + duration
    coarse = duration - spin_threshold
    if coarse > 0:
        time.sleep(coarse)
    while time.perf_counter() < deadline:
        pass
