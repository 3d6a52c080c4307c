"""Real-time integration layer: manager, task decorators, adapters.

A framework-free copy of :mod:`dart_planner_tpu.runtime.integration`: the port keeps its own,
since the JAX package cannot be imported without jax.

Equivalent of the reference ``common/real_time_integration.py`` ("RTI"):
the ``RealTimeManager`` singleton wiring control/planning/safety
functions into the scheduler (RTI:285-400), the ``@real_time_task`` /
``@control_loop_task`` / ``@planning_loop_task`` / ``@safety_task``
decorators (RTI:413-491), and the ``integrate_with_controller/planner/
safety_system`` adapters (RTI:567-629).

Differences from the reference, on purpose:

- Built on our single ``QuarticScheduler`` (runtime/scheduler.py) — the
  reference maintains two parallel schedulers and RTI binds to the
  thread-based one.
- The reference's ``integrate_with_*`` adapters are stubs whose inner
  functions are literally ``pass`` (RTI:573-578,603-607,619-625); ours
  actually call the component through caller-supplied state/command
  plumbing, because compute here is pure functions — the adapter owns
  the side-effectful glue.
- ``manager.start()`` spawns the scheduler loop as a background asyncio
  task and returns; the reference's ``await scheduler.start()`` never
  yields control back to the caller that started it.
- A process-global singleton is kept for decorator ergonomics
  (RTI:405-410) but is reset-able for tests.
"""

from __future__ import annotations

import asyncio
import contextlib
from typing import Any, Callable, Dict, Optional

from dart_planner_tpu_torch.common.logging_config import get_logger
from dart_planner_tpu_torch.runtime.scheduler import (
    QuarticScheduler,
    QuarticTask,
    TaskPriority,
    create_control_task,
    create_planning_task,
    create_safety_task,
)

logger = get_logger("runtime.integration")


class RealTimeManager:
    """Wires control/planning/safety callables into one scheduler
    (RTI:285-400)."""

    def __init__(self, scheduler: Optional[QuarticScheduler] = None):
        self.scheduler = scheduler or QuarticScheduler()
        self.running = False
        self._loop_task: Optional[asyncio.Task] = None
        self.control_task: Optional[QuarticTask] = None
        self.planning_task: Optional[QuarticTask] = None
        self.safety_task: Optional[QuarticTask] = None
        # late-bound bodies so tasks can be created before functions are
        # known and swapped while running (RTI:300-327)
        self._control_func: Optional[Callable[[], Any]] = None
        self._planning_func: Optional[Callable[[], Any]] = None
        self._safety_func: Optional[Callable[[], Any]] = None

    # -- function slots (RTI:340-385) --
    def set_control_function(
        self, func: Callable[[], Any], frequency_hz: float = 400.0
    ) -> None:
        self._control_func = func
        if self.control_task is None:
            self.control_task = create_control_task(
                self._run_control, frequency_hz=frequency_hz
            )
            self.scheduler.add_task(self.control_task)

    def set_planning_function(
        self, func: Callable[[], Any], frequency_hz: float = 50.0
    ) -> None:
        self._planning_func = func
        if self.planning_task is None:
            self.planning_task = create_planning_task(
                self._run_planning, frequency_hz=frequency_hz
            )
            self.scheduler.add_task(self.planning_task)

    def set_safety_function(
        self, func: Callable[[], Any], frequency_hz: float = 100.0
    ) -> None:
        self._safety_func = func
        if self.safety_task is None:
            self.safety_task = create_safety_task(
                self._run_safety, frequency_hz=frequency_hz
            )
            self.scheduler.add_task(self.safety_task)

    def _run_control(self):
        if self._control_func is not None:
            return self._control_func()

    def _run_planning(self):
        if self._planning_func is not None:
            return self._planning_func()

    def _run_safety(self):
        if self._safety_func is not None:
            return self._safety_func()

    # -- custom tasks (RTI:387-395) --
    def add_custom_task(self, task: QuarticTask) -> None:
        self.scheduler.add_task(task)

    def remove_custom_task(self, task_name: str) -> None:
        self.scheduler.remove_task(task_name)

    # -- lifecycle (RTI:329-338) --
    async def start(self) -> None:
        if not self.running:
            self.running = True
            self._loop_task = asyncio.create_task(self.scheduler.start())
            await asyncio.sleep(0)  # let the loop spin up

    async def stop(self) -> None:
        if self.running:
            await self.scheduler.stop()
            self.running = False
            if self._loop_task is not None:
                self._loop_task.cancel()
                with contextlib.suppress(asyncio.CancelledError):
                    await self._loop_task
                self._loop_task = None

    async def run_for(self, duration_s: float) -> None:
        """Start, run for ``duration_s``, stop (RTI:528-553)."""
        await self.start()
        try:
            await asyncio.sleep(duration_s)
        finally:
            await self.stop()

    def get_stats(self) -> Dict[str, Any]:
        return {
            "global": self.scheduler.get_global_stats(),
            "tasks": self.scheduler.get_all_stats(),
        }


_MANAGER: Optional[RealTimeManager] = None


def get_real_time_manager() -> RealTimeManager:
    """Process-global manager used by the decorators (RTI:405-410)."""
    global _MANAGER
    if _MANAGER is None:
        _MANAGER = RealTimeManager()
    return _MANAGER


def reset_real_time_manager() -> None:
    """Drop the singleton (tests / app restarts). The old scheduler must
    already be stopped; its tasks are discarded."""
    global _MANAGER
    _MANAGER = None


# -- decorators (RTI:413-491) --
def real_time_task(
    frequency_hz: float = 50.0,
    priority: TaskPriority = TaskPriority.MEDIUM,
    deadline_fraction: float = 0.8,
    name: Optional[str] = None,
    manager: Optional[RealTimeManager] = None,
):
    """Register a function as a periodic task on the manager's
    scheduler (RTI:413-448). Returns the function unchanged."""

    def decorator(func: Callable[[], Any]) -> Callable[[], Any]:
        mgr = manager or get_real_time_manager()
        mgr.add_custom_task(
            QuarticTask(
                name=name or func.__name__,
                func=func,
                frequency_hz=frequency_hz,
                priority=priority,
                deadline_fraction=deadline_fraction,
            )
        )
        return func

    return decorator


def control_loop_task(
    frequency_hz: float = 400.0,
    name: Optional[str] = None,  # accepted for RTI:450 parity; unused
    manager: Optional[RealTimeManager] = None,
):
    """Register a function as THE control loop (RTI:450-462)."""

    def decorator(func: Callable[[], Any]) -> Callable[[], Any]:
        (manager or get_real_time_manager()).set_control_function(
            func, frequency_hz=frequency_hz
        )
        return func

    return decorator


def planning_loop_task(
    frequency_hz: float = 50.0,
    name: Optional[str] = None,
    manager: Optional[RealTimeManager] = None,
):
    """Register a function as THE planning loop (RTI:464-476)."""

    def decorator(func: Callable[[], Any]) -> Callable[[], Any]:
        (manager or get_real_time_manager()).set_planning_function(
            func, frequency_hz=frequency_hz
        )
        return func

    return decorator


def safety_task(
    frequency_hz: float = 100.0,
    name: Optional[str] = None,
    manager: Optional[RealTimeManager] = None,
):
    """Register a function as THE safety monitor (RTI:478-485)."""

    def decorator(func: Callable[[], Any]) -> Callable[[], Any]:
        (manager or get_real_time_manager()).set_safety_function(
            func, frequency_hz=frequency_hz
        )
        return func

    return decorator


# -- component adapters (RTI:567-629) --
def integrate_with_controller(
    controller,
    get_state: Callable[[], Any],
    get_setpoint: Callable[[], Any],
    send_command: Callable[[Any], None],
    frequency_hz: float = 400.0,
    manager: Optional[RealTimeManager] = None,
) -> RealTimeManager:
    """Run ``controller.compute_control(state, *setpoint)`` at the
    control rate, feeding ``send_command`` (RTI:567-578, made real)."""
    mgr = manager or get_real_time_manager()

    def control_function():
        state = get_state()
        setpoint = get_setpoint()
        cmd = controller.compute_control(state, *setpoint)
        send_command(cmd)

    mgr.set_control_function(control_function, frequency_hz=frequency_hz)
    return mgr


def integrate_with_planner(
    planner,
    get_state: Callable[[], Any],
    get_goal: Callable[[], Any],
    send_trajectory: Callable[[Any], None],
    frequency_hz: float = 10.0,
    manager: Optional[RealTimeManager] = None,
) -> RealTimeManager:
    """Run ``planner.plan_trajectory(state, goal)`` at the planning rate
    (RTI:594-609, made real)."""
    mgr = manager or get_real_time_manager()

    def planning_function():
        traj = planner.plan_trajectory(get_state(), get_goal())
        send_trajectory(traj)

    mgr.set_planning_function(planning_function, frequency_hz=frequency_hz)
    return mgr


def integrate_with_safety_system(
    safety_system,
    get_state: Callable[[], Any],
    on_violation: Callable[[Any], None],
    frequency_hz: float = 100.0,
    manager: Optional[RealTimeManager] = None,
) -> RealTimeManager:
    """Run ``safety_system.check(state)`` at the safety rate; any truthy
    result (violation report) goes to ``on_violation``
    (RTI:613-629, made real)."""
    mgr = manager or get_real_time_manager()

    def safety_function():
        report = safety_system.check(get_state())
        if report:
            on_violation(report)

    mgr.set_safety_function(safety_function, frequency_hz=frequency_hz)
    return mgr
