"""GIL-escaping process control loop (PyTorch counterpart
of :mod:`dart_planner_tpu.runtime.multiprocess_loop`).

Port of the reference ``common/multiprocess_control_loop.py``
(``ProcessControlLoop``, :13-55): runs a control function in a separate
process at a fixed rate, exchanging state/commands over pipes. On this
stack it exists mainly for CPU-bound auxiliary work (logging, telemetry
encoding); the real-time path belongs to the C++ executor
(:mod:`dart_planner_tpu_torch.runtime.rt_executor`).

The child starts from the default ``multiprocessing`` context, as the JAX
package's does: on Linux a fork of the caller. What crosses the pipes is
host data (numpy arrays, Python values; read a tensor on the card to the
host with :func:`~dart_planner_tpu_torch.common.device.to_host` first).
The child of a process that has started CUDA must not touch CUDA: a forked
child cannot use the parent's CUDA context, so ``control_fn`` runs on the
host only.
"""

from __future__ import annotations

import multiprocessing as mp
import time
from typing import Any, Callable, Optional


def _worker(fn, frequency_hz: float, conn, stop_event) -> None:
    period = 1.0 / frequency_hz
    state: Any = None
    iterations = 0
    next_deadline = time.perf_counter() + period
    while not stop_event.is_set():
        while conn.poll():
            state = conn.recv()
        if state is not None:
            try:
                out = fn(state)
            except Exception as e:  # surface errors instead of dying silently
                conn.send({"__error__": repr(e)})
                break
            conn.send(out)
            iterations += 1
        rem = next_deadline - time.perf_counter()
        if rem > 0:
            time.sleep(rem)
        next_deadline += period
        if next_deadline < time.perf_counter():
            next_deadline = time.perf_counter() + period


class ProcessControlLoop:
    """(reference multiprocess_control_loop.py:13-55)"""

    def __init__(self, control_fn: Callable[[Any], Any], frequency_hz: float = 100.0):
        self.control_fn = control_fn
        self.frequency_hz = frequency_hz
        self._parent_conn, self._child_conn = mp.Pipe()
        self._stop = mp.Event()
        self._proc: Optional[mp.Process] = None
        self.last_output: Any = None
        self.error: Optional[str] = None

    def start(self) -> None:
        self._proc = mp.Process(
            target=_worker,
            args=(self.control_fn, self.frequency_hz, self._child_conn, self._stop),
            daemon=True,
        )
        self._proc.start()

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        if self._proc is not None:
            self._proc.join(timeout)
            if self._proc.is_alive():
                self._proc.kill()  # exact child PID only
            self._proc = None

    def send_state(self, state: Any) -> None:
        self._parent_conn.send(state)

    def get_output(self, timeout: float = 0.0) -> Any:
        while self._parent_conn.poll(timeout):
            out = self._parent_conn.recv()
            if isinstance(out, dict) and "__error__" in out:
                self.error = out["__error__"]
            else:
                self.last_output = out
            timeout = 0.0
        return self.last_output

    @property
    def running(self) -> bool:
        return self._proc is not None and self._proc.is_alive()
