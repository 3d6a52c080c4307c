"""Intermediate: cooperative real-time scheduler with jitter stats.

PyTorch counterpart of examples/intermediate/scheduler_demo.py, after the
reference's quartic_scheduler_demo.py: control, planning and safety tasks
at 200/25/50 Hz for two seconds, then a per-task timing report
(executions, deadline misses, jitter RMS on the host clock). It makes no
tensor, so it takes no device.

    PYTHONPATH=. python examples_torch/intermediate/scheduler_demo.py
"""

import asyncio

from dart_planner_tpu_torch.runtime.scheduler import (
    QuarticScheduler,
    create_control_task,
    create_planning_task,
    create_safety_task,
)


async def demo(seconds: float = 2.0) -> dict:
    """Run the three tasks for ``seconds``; returns the tick counts and the
    scheduler's per-task stats."""
    counters = {"control": 0, "planning": 0, "safety": 0}

    def counter(name):
        def tick():
            counters[name] += 1
        return tick

    sched = QuarticScheduler()
    sched.add_task(create_control_task(counter("control"), frequency_hz=200.0))
    sched.add_task(create_planning_task(counter("planning"), frequency_hz=25.0))
    sched.add_task(create_safety_task(counter("safety"), frequency_hz=50.0))

    run = asyncio.ensure_future(sched.start())
    await asyncio.sleep(seconds)
    await sched.stop()
    run.cancel()

    print(f"tick counts over {seconds:g} s: {counters}")
    stats = sched.get_all_stats()
    for name, st in stats.items():
        print(
            f"  {name:>9}: {st['execution_count']} runs, "
            f"{st['missed_deadlines']} misses, "
            f"jitter RMS {st.get('jitter_rms_ms', 0.0):.3f} ms"
        )
    return {"counters": counters, "stats": stats}


def main(seconds: float = 2.0) -> dict:
    return asyncio.run(demo(seconds))


if __name__ == "__main__":
    main()
