"""Cooperative asyncio real-time scheduler.

A framework-free copy of :mod:`dart_planner_tpu.runtime.scheduler`: the port keeps its own,
since the JAX package cannot be imported without jax.

Re-implementation of the reference ``QuarticScheduler``
(the reference's common/quartic_scheduler.py, "QS"):
priority+deadline task selection (QS:259-280), per-task execution-time
deques with jitter stats (QS:297-320), overrun accounting with
auto-disable after 10 consecutive overruns (QS:329-352), and the
400/50/100 Hz control/planning/safety task factories with 80/90/70%
deadline fractions (QS:579-614). Monitoring histograms are exposed as raw
arrays (matplotlib optional) instead of PNG side effects.
"""

from __future__ import annotations

import asyncio
import contextlib
import enum
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Dict, Optional

import numpy as np


class TaskPriority(enum.IntEnum):
    """Lower value = higher priority (QS task ordering)."""

    CRITICAL = 0  # safety
    HIGH = 1  # control
    MEDIUM = 2  # planning
    LOW = 3  # telemetry / logging


@dataclass
class QuarticTask:
    """Periodic task descriptor (QS:38-66)."""

    name: str
    func: Callable[[], Any | Awaitable[Any]]
    frequency_hz: float
    priority: TaskPriority = TaskPriority.MEDIUM
    deadline_fraction: float = 0.8  # deadline = fraction * period
    enabled: bool = True
    # per-task override of the scheduler's auto-disable threshold; None
    # uses the scheduler default. Set high for tasks whose overruns are
    # governed by another failsafe (e.g. comms timeouts -> tier decay).
    max_consecutive_overruns: Optional[int] = None

    # runtime state
    next_execution: float = 0.0
    execution_count: int = 0
    missed_deadlines: int = 0
    overruns: int = 0  # executions longer than the period
    execution_times_ms: deque = field(default_factory=lambda: deque(maxlen=1000))
    intervals_ms: deque = field(default_factory=lambda: deque(maxlen=1000))
    last_start: float = 0.0
    # set while an async body is running as a background asyncio task;
    # the scheduler will not re-dispatch until it completes
    in_flight: bool = False

    @property
    def period_s(self) -> float:
        return 1.0 / self.frequency_hz

    @property
    def deadline_s(self) -> float:
        return self.period_s * self.deadline_fraction


class QuarticScheduler:
    """(QS:90-497)"""

    def __init__(
        self,
        enable_monitoring: bool = True,
        max_jitter_ms: float = 1.0,
        max_consecutive_overruns: int = 10,
    ):
        self.tasks: Dict[str, QuarticTask] = {}
        self.enable_monitoring = enable_monitoring
        self.max_jitter_ms = max_jitter_ms
        self.max_consecutive_overruns = max_consecutive_overruns
        self.running = False
        self.total_overruns = 0
        self.total_executions = 0
        self.consecutive_overrun_counts: Dict[str, int] = {}
        self._stop_event: Optional[asyncio.Event] = None
        self._in_flight_tasks: set = set()

    # -- task management (QS:160-188) --
    def add_task(self, task: QuarticTask) -> None:
        task.next_execution = time.perf_counter()
        self.tasks[task.name] = task

    def remove_task(self, task_name: str) -> None:
        self.tasks.pop(task_name, None)

    def enable_task(self, task_name: str) -> None:
        if task_name in self.tasks:
            self.tasks[task_name].enabled = True
            self.consecutive_overrun_counts[task_name] = 0

    def disable_task(self, task_name: str) -> None:
        if task_name in self.tasks:
            self.tasks[task_name].enabled = False

    # -- lifecycle (QS:190-257) --
    async def start(self) -> None:
        self.running = True
        self._stop_event = asyncio.Event()
        await self._scheduler_loop()

    async def stop(self) -> None:
        self.running = False
        if self._stop_event is not None:
            self._stop_event.set()
        # cancel async bodies still in flight (their done-callbacks run
        # and clear in_flight/accounting marks them failed)
        for bg in list(self._in_flight_tasks):
            bg.cancel()
        if self._in_flight_tasks:
            await asyncio.gather(
                *self._in_flight_tasks, return_exceptions=True
            )

    async def _scheduler_loop(self) -> None:
        while self.running:
            now = time.perf_counter()
            task = self._find_next_task(now)
            if task is not None:
                await self._execute_task(task, now)
            else:
                await asyncio.sleep(self._sleep_time(now))

    def _find_next_task(self, now: float) -> Optional[QuarticTask]:
        """Priority then earliest-deadline among ready tasks (QS:259-280)."""
        ready = [
            t
            for t in self.tasks.values()
            if t.enabled and not t.in_flight and now >= t.next_execution
        ]
        if not ready:
            return None
        ready.sort(key=lambda t: (t.priority.value, t.next_execution))
        return ready[0]

    async def _execute_task(self, task: QuarticTask, now: float) -> None:
        """Run one task with timing/overrun accounting (QS:282-356).

        A body that returns a coroutine is run as a BACKGROUND asyncio
        task so it cannot stall the cooperative loop (e.g. a comms
        exchange awaiting a thread-pool socket poll must not starve a
        400 Hz control tick — the reference scheduler awaits every body
        inline and has exactly that starvation, edge/main_improved.py's
        10 Hz ZMQ call freezing the 1 kHz loop for the poll timeout).
        The task is not re-dispatched while its previous instance is in
        flight; timing/overrun accounting happens at completion."""
        start = time.perf_counter()
        if task.last_start > 0:
            task.intervals_ms.append((start - task.last_start) * 1000.0)
        task.last_start = start
        failed = False
        result = None
        try:
            result = task.func()
        except Exception:
            # a failing task must not kill the loop; disable after repeats
            failed = True

        if asyncio.iscoroutine(result):
            task.in_flight = True
            bg = asyncio.ensure_future(result)
            self._in_flight_tasks.add(bg)

            def _done(fut: "asyncio.Future", task=task, start=start) -> None:
                self._in_flight_tasks.discard(fut)
                task.in_flight = False
                err = fut.cancelled() or fut.exception() is not None
                self._account(task, start, failed=err)

            bg.add_done_callback(_done)
        else:
            self._account(task, start, failed=failed)

        await asyncio.sleep(0)  # cooperative yield

    def _account(self, task: QuarticTask, start: float, failed: bool) -> None:
        """Completion-time deadline/overrun bookkeeping (QS:329-356)."""
        elapsed_ms = (time.perf_counter() - start) * 1000.0
        task.execution_times_ms.append(elapsed_ms)
        task.execution_count += 1
        self.total_executions += 1

        if elapsed_ms / 1000.0 > task.deadline_s:
            task.missed_deadlines += 1
        if failed or elapsed_ms > task.period_s * 1000.0:
            if elapsed_ms > task.period_s * 1000.0:
                self.total_overruns += 1
                task.overruns += 1
            c = self.consecutive_overrun_counts.get(task.name, 0) + 1
            self.consecutive_overrun_counts[task.name] = c
            limit = (
                task.max_consecutive_overruns
                if task.max_consecutive_overruns is not None
                else self.max_consecutive_overruns
            )
            if c >= limit:
                task.enabled = False  # auto-disable (QS:342-349)
                self.consecutive_overrun_counts[task.name] = 0
        else:
            self.consecutive_overrun_counts[task.name] = 0

        # schedule next period, skipping missed slots (no catch-up bursts)
        task.next_execution += task.period_s
        now2 = time.perf_counter()
        if task.next_execution < now2:
            missed = int((now2 - task.next_execution) / task.period_s) + 1
            task.next_execution += missed * task.period_s

    def _sleep_time(self, now: float) -> float:
        """Sleep until the earliest next execution (QS:358-379)."""
        nexts = [t.next_execution for t in self.tasks.values() if t.enabled]
        if not nexts:
            return 0.001
        return float(np.clip(min(nexts) - now, 0.0001, 0.01))

    # -- statistics (QS:437-497) --
    def get_task_stats(self, task_name: str) -> Optional[Dict[str, Any]]:
        t = self.tasks.get(task_name)
        if t is None:
            return None
        times = np.asarray(t.execution_times_ms) if t.execution_times_ms else None
        iv = np.asarray(t.intervals_ms) if t.intervals_ms else None
        stats: Dict[str, Any] = {
            "name": t.name,
            "frequency_hz": t.frequency_hz,
            "enabled": t.enabled,
            "execution_count": t.execution_count,
            "missed_deadlines": t.missed_deadlines,
            "overruns": t.overruns,
        }
        if times is not None and times.size:
            stats.update(
                mean_execution_ms=float(times.mean()),
                max_execution_ms=float(times.max()),
                p95_execution_ms=float(np.percentile(times, 95)),
            )
        if iv is not None and iv.size:
            jitter = iv - 1000.0 * t.period_s
            stats.update(
                jitter_rms_ms=float(np.sqrt(np.mean(jitter**2))),
                achieved_frequency_hz=float(1000.0 / iv.mean()),
            )
        return stats

    def get_all_stats(self) -> Dict[str, Dict[str, Any]]:
        return {
            name: self.get_task_stats(name) or {} for name in self.tasks
        }

    def get_global_stats(self) -> Dict[str, Any]:
        return {
            "total_executions": self.total_executions,
            "total_overruns": self.total_overruns,
            "task_count": len(self.tasks),
            "running": self.running,
        }

    def get_jitter_histogram(
        self, task_name: str, bins: int = 50
    ) -> Optional[tuple]:
        """Raw (counts, edges) jitter histogram (QS:498-575 drew PNGs)."""
        t = self.tasks.get(task_name)
        if t is None or not t.intervals_ms:
            return None
        jitter = np.asarray(t.intervals_ms) - 1000.0 * t.period_s
        return np.histogram(jitter, bins=bins)


# -- task factories (QS:579-614) --
def create_control_task(
    func: Callable, frequency_hz: float = 400.0, name: str = "control"
) -> QuarticTask:
    return QuarticTask(
        name=name,
        func=func,
        frequency_hz=frequency_hz,
        priority=TaskPriority.HIGH,
        deadline_fraction=0.8,
    )


def create_planning_task(
    func: Callable, frequency_hz: float = 50.0, name: str = "planning"
) -> QuarticTask:
    return QuarticTask(
        name=name,
        func=func,
        frequency_hz=frequency_hz,
        priority=TaskPriority.MEDIUM,
        deadline_fraction=0.9,
    )


def create_safety_task(
    func: Callable, frequency_hz: float = 100.0, name: str = "safety"
) -> QuarticTask:
    return QuarticTask(
        name=name,
        func=func,
        frequency_hz=frequency_hz,
        priority=TaskPriority.CRITICAL,
        deadline_fraction=0.7,
    )


@contextlib.asynccontextmanager
async def quartic_scheduler_context(
    enable_monitoring: bool = True, max_jitter_ms: float = 1.0
):
    """(QS:616-625)"""
    sched = QuarticScheduler(enable_monitoring, max_jitter_ms)
    loop_task = None
    try:
        loop_task = asyncio.create_task(sched.start())
        await asyncio.sleep(0)
        yield sched
    finally:
        await sched.stop()
        if loop_task is not None:
            with contextlib.suppress(asyncio.CancelledError):
                loop_task.cancel()
                await asyncio.gather(loop_task, return_exceptions=True)
