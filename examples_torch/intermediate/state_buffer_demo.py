"""Intermediate: thread-safe state buffer between producer and consumer.

PyTorch counterpart of examples/intermediate/state_buffer_demo.py: an
estimator thread publishes ``DroneState``s (tensors on the card by
default, or with ``--device cpu`` on the CPU) at 200 Hz while the main
thread reads latest/at-time snapshots and statistics.

    PYTHONPATH=. python examples_torch/intermediate/state_buffer_demo.py [--device cpu]
"""

import argparse
import math
import threading
import time

from dart_planner_tpu_torch.common.device import resolve_device
from dart_planner_tpu_torch.common.state_buffer import ThreadSafeStateBuffer
from dart_planner_tpu_torch.common.types import DroneState


def main(device=None) -> dict:
    """Publish for 0.5 s, then read; returns the latest version and time,
    the time of the snapshot 50 ms before it, and the buffer's stats."""
    dev = resolve_device(device)
    buf = ThreadSafeStateBuffer(buffer_size=32)
    stop = threading.Event()

    def estimator() -> None:
        t = 0.0
        while not stop.is_set():
            state = DroneState.create(
                timestamp=t, position=(0.0, 0.0, 2.0 + 0.1 * math.sin(t)), device=dev
            )
            buf.update_state(state, timestamp=t)
            t += 0.005
            time.sleep(0.005)

    # the first DroneState on the device (on the card: its context and
    # first copies) is made on the main thread, so the estimator loop runs
    # at a steady 200 Hz
    DroneState.create(timestamp=0.0, position=(0.0, 0.0, 2.0), device=dev)
    thread = threading.Thread(target=estimator, daemon=True)
    thread.start()
    try:
        deadline = time.time() + 5.0
        while buf.get_latest_state() is None and time.time() < deadline:
            time.sleep(0.05)
        time.sleep(0.5)

        snap = buf.get_latest_state()
        print(f"latest: version={snap.version} t={float(snap.timestamp):.3f}")
        past = buf.get_state_at_time(float(snap.timestamp) - 0.05)
        print(f"50 ms ago: t={float(past.timestamp):.3f}")
        stats = buf.get_statistics()
        print("stats:", stats)
    finally:
        stop.set()
        thread.join(timeout=1.0)
    return {"version": snap.version, "timestamp": float(snap.timestamp),
            "past_timestamp": float(past.timestamp), "stats": stats}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="torch device (default: the card)")
    main(device=parser.parse_args().device)
