"""Beginner: heartbeat monitoring and loss-triggered emergency.

PyTorch counterpart of examples/beginner/heartbeat_demo.py: a monitor
receives heartbeats for a while, then the link "fails" and the emergency
callback fires after the configured timeout. It makes no tensor, so it
takes no device.

    PYTHONPATH=. python examples_torch/beginner/heartbeat_demo.py
"""

import asyncio
import time

from dart_planner_tpu_torch.comms.heartbeat import HeartbeatConfig, HeartbeatMonitor


async def demo() -> dict:
    """Ten heartbeats, then none; returns whether the emergency fired and
    how long after the last heartbeat (s)."""
    fired = asyncio.Event()

    monitor = HeartbeatMonitor(
        HeartbeatConfig(interval_ms=100, timeout_ms=300),
        emergency_callback=fired.set,
    )
    monitor.start_monitoring()

    print("link healthy: sending heartbeats for 1 s ...")
    for _ in range(10):
        monitor.heartbeat_received_sync()
        await asyncio.sleep(0.1)
    if monitor.emergency_triggered:
        raise RuntimeError("the emergency fired while heartbeats arrived")

    print("link failed: heartbeats stop ...")
    t_lost = monitor.last_received
    await asyncio.wait_for(fired.wait(), timeout=2.0)
    after = time.time() - t_lost
    print("emergency callback fired (timeout exceeded) — failsafe engaged")
    monitor.stop_monitoring()
    return {"emergency_triggered": monitor.emergency_triggered, "fired_after_s": after}


def main() -> dict:
    return asyncio.run(demo())


if __name__ == "__main__":
    main()
