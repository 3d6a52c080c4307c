"""Host runtime: the planner-to-actuator fast path, the C++ real-time
executor bindings, the cooperative asyncio scheduler and the real-time
integration layer, and the multi-process loop (PyTorch counterpart of
:mod:`dart_planner_tpu.runtime`)."""

from dart_planner_tpu_torch.runtime.scheduler import (
    QuarticScheduler,
    QuarticTask,
    TaskPriority,
    create_control_task,
    create_planning_task,
    create_safety_task,
    quartic_scheduler_context,
)
from dart_planner_tpu_torch.runtime.rt_executor import (
    PythonControlLoop,
    RealTimeControlLoop,
    create_control_loop,
    native_available,
)
from dart_planner_tpu_torch.runtime.integration import (
    RealTimeManager,
    control_loop_task,
    get_real_time_manager,
    integrate_with_controller,
    integrate_with_planner,
    integrate_with_safety_system,
    planning_loop_task,
    real_time_task,
    reset_real_time_manager,
    safety_task,
)

__all__ = [
    "QuarticScheduler",
    "QuarticTask",
    "TaskPriority",
    "create_control_task",
    "create_planning_task",
    "create_safety_task",
    "quartic_scheduler_context",
    "PythonControlLoop",
    "RealTimeControlLoop",
    "create_control_loop",
    "native_available",
    "RealTimeManager",
    "control_loop_task",
    "get_real_time_manager",
    "integrate_with_controller",
    "integrate_with_planner",
    "integrate_with_safety_system",
    "planning_loop_task",
    "real_time_task",
    "reset_real_time_manager",
    "safety_task",
]
