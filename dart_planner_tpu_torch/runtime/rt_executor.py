"""ctypes bindings to the C++ real-time executor.

Python façade over ``native/rt_executor.cpp`` with the reference
extension's ergonomics (``RealTimeControlLoop`` with start/stop/
set_state/get_command/get_stats + ``create_control_loop``,
rt_control_extension.pyx:79,487). The shared library is built with g++ on
first use into ``build/native/`` at the root of the checkout (its own file,
written under a temporary name and moved into place, so no process loads a
half-written library); if no compiler is available the
pure-Python :class:`PythonControlLoop` fallback keeps the API alive
(mirroring the reference's optional-extension design,
rt_control_wrapper.py graceful fallback).
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading
import time
from typing import Optional

import numpy as np

from dart_planner_tpu_torch.common.errors import RealTimeError

_ROOT = pathlib.Path(__file__).resolve().parents[2]
_SOURCE = _ROOT / "native" / "rt_executor.cpp"
_LIB_PATH = _ROOT / "build" / "native" / "librt_executor.so"

MAX_CONTROL_FREQUENCY = 1000.0  # Hz (pyx:28)
DEADLINE_MARGIN = 50e-6  # s (pyx:31)

_lib: Optional[ctypes.CDLL] = None
_lib_error: Optional[str] = None


def _build_library() -> bool:
    if not _SOURCE.exists():
        return False
    tmp = _LIB_PATH.with_name(f"{_LIB_PATH.name}.{os.getpid()}.tmp")
    try:
        _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            [
                "g++",
                "-O3",
                "-march=native",
                "-std=c++17",
                "-fPIC",
                "-shared",
                str(_SOURCE),
                "-o",
                str(tmp),
                "-lpthread",
            ],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, _LIB_PATH)
        return True
    except (subprocess.SubprocessError, OSError):
        return False
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_error
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists() and not _build_library():
        _lib_error = "g++ unavailable or build failed"
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError as e:
        _lib_error = str(e)
        return None
    lib.rt_create.restype = ctypes.c_void_p
    lib.rt_create.argtypes = [ctypes.c_double]
    lib.rt_destroy.argtypes = [ctypes.c_void_p]
    lib.rt_start.argtypes = [ctypes.c_void_p]
    lib.rt_stop.argtypes = [ctypes.c_void_p]
    for f in (lib.rt_set_state, lib.rt_set_setpoint, lib.rt_set_gains):
        f.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
    lib.rt_get_command.restype = ctypes.c_int
    lib.rt_get_command.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.rt_get_stats.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.rt_get_exec_times.restype = ctypes.c_int
    lib.rt_get_exec_times.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int,
    ]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def _pack13(pos, vel, att, omega, scalar) -> ctypes.Array:
    buf = (ctypes.c_double * 13)()
    arr = np.concatenate(
        [
            np.asarray(pos, float),
            np.asarray(vel, float),
            np.asarray(att, float),
            np.asarray(omega, float),
            [float(scalar)],
        ]
    )
    buf[:] = arr.tolist()
    return buf


class RealTimeControlLoop:
    """C++-backed fixed-rate loop (reference RealTimeControlLoop, pyx:79)."""

    def __init__(self, frequency_hz: float = 400.0):
        if frequency_hz > MAX_CONTROL_FREQUENCY:
            raise RealTimeError(
                f"frequency {frequency_hz} > {MAX_CONTROL_FREQUENCY} Hz limit"
            )
        lib = _load()
        if lib is None:
            raise RealTimeError(f"native rt_executor unavailable: {_lib_error}")
        self._lib = lib
        self._h = lib.rt_create(ctypes.c_double(frequency_hz))
        self.frequency_hz = frequency_hz
        self._running = False

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.rt_destroy(self._h)
                self._h = None
        except Exception:
            pass

    def start(self) -> None:
        self._lib.rt_start(self._h)
        self._running = True

    def stop(self) -> None:
        self._lib.rt_stop(self._h)
        self._running = False

    def set_state(self, position, velocity, attitude, angular_velocity, timestamp=None):
        self._lib.rt_set_state(
            self._h,
            _pack13(
                position,
                velocity,
                attitude,
                angular_velocity,
                timestamp if timestamp is not None else time.time(),
            ),
        )

    def set_setpoint(
        self, position, velocity, attitude, angular_velocity, thrust_ff=0.0
    ):
        self._lib.rt_set_setpoint(
            self._h,
            _pack13(position, velocity, attitude, angular_velocity, thrust_ff),
        )

    def set_gains(self, kp_pos, ki_pos, kd_pos, kp_att, ki_att, kd_att) -> None:
        buf = (ctypes.c_double * 18)()
        buf[:] = (
            list(kp_pos) + list(ki_pos) + list(kd_pos)
            + list(kp_att) + list(ki_att) + list(kd_att)
        )
        self._lib.rt_set_gains(self._h, buf)

    def get_command(self) -> Optional[dict]:
        out = (ctypes.c_double * 5)()
        if not self._lib.rt_get_command(self._h, out):
            return None
        return {
            "thrust": out[0],
            "roll_rate": out[1],
            "pitch_rate": out[2],
            "yaw_rate": out[3],
            "iteration": int(out[4]),
        }

    def get_execution_times(self) -> np.ndarray:
        """Raw per-tick execution times (s) from the 1000-entry circular
        buffer, for host-side order statistics (p95/p99 — the reference's
        CI gates, tests/test_real_time_latency.py:109-120)."""
        buf = (ctypes.c_double * 1000)()
        n = self._lib.rt_get_exec_times(self._h, buf, 1000)
        return np.asarray(buf[:n])

    def get_stats(self) -> dict:
        """Stat names match the reference (pyx:285-338)."""
        out = (ctypes.c_double * 10)()
        self._lib.rt_get_stats(self._h, out)
        n = out[0]
        return {
            "iteration_count": int(n),
            "missed_deadlines": int(out[1]),
            "mean_execution_time_ms": out[2] * 1e3,
            "max_execution_time_ms": out[3] * 1e3,
            "min_execution_time_ms": out[4] * 1e3,
            "jitter_rms_ms": out[5] * 1e3,
            "frequency_actual_hz": out[6],
            "frequency_target_hz": out[7],
            "interval_jitter_rms_ms": out[8] * 1e3,
            "running": bool(out[9]),
            "success_rate": (n - out[1]) / max(n, 1.0),
        }


class PythonControlLoop:
    """Pure-Python fallback with the same API (thread + sleep; no RT
    guarantees — mirrors the reference's fallback when the extension is
    not built, rt_control_wrapper.py)."""

    def __init__(self, frequency_hz: float = 400.0):
        self.frequency_hz = min(frequency_hz, MAX_CONTROL_FREQUENCY)
        self.period = 1.0 / self.frequency_hz
        self._lock = threading.Lock()
        self._state = None
        self._setpoint = None
        self._gains = None
        self._command = None
        self._pos_integral = np.zeros(3)
        self._att_integral = np.zeros(3)
        self._iterations = 0
        self._missed = 0
        self._exec_times: list = []
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._t0 = 0.0

    def start(self) -> None:
        self._running = True
        self._t0 = time.perf_counter()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread:
            self._thread.join(timeout=2.0)

    def set_state(self, position, velocity, attitude, angular_velocity, timestamp=None):
        with self._lock:
            self._state = (
                np.asarray(position, float),
                np.asarray(velocity, float),
                np.asarray(attitude, float),
                np.asarray(angular_velocity, float),
            )

    def set_setpoint(self, position, velocity, attitude, angular_velocity, thrust_ff=0.0):
        with self._lock:
            self._setpoint = (
                np.asarray(position, float),
                np.asarray(velocity, float),
                np.asarray(attitude, float),
                np.asarray(angular_velocity, float),
                float(thrust_ff),
            )

    def set_gains(self, kp_pos, ki_pos, kd_pos, kp_att, ki_att, kd_att):
        with self._lock:
            self._gains = tuple(np.asarray(g, float) for g in
                                (kp_pos, ki_pos, kd_pos, kp_att, ki_att, kd_att))

    def _run(self):
        next_deadline = time.perf_counter() + self.period
        while self._running:
            t0 = time.perf_counter()
            if t0 > next_deadline + DEADLINE_MARGIN:
                self._missed += 1
            self._iterate()
            self._exec_times.append(time.perf_counter() - t0)
            if len(self._exec_times) > 1000:
                self._exec_times = self._exec_times[-1000:]
            self._iterations += 1
            rem = next_deadline - time.perf_counter()
            if rem > 0:
                time.sleep(rem)
            next_deadline += self.period
            if next_deadline < time.perf_counter():
                next_deadline = time.perf_counter() + self.period

    def _iterate(self):
        with self._lock:
            if self._state is None or self._setpoint is None or self._gains is None:
                return
            pos, vel, att, omega = self._state
            sp_pos, sp_vel, sp_att, sp_omega, thrust_ff = self._setpoint
            kp_pos, ki_pos, kd_pos, kp_att, ki_att, kd_att = self._gains
            dt = self.period
            pe, ve = sp_pos - pos, sp_vel - vel
            self._pos_integral = np.clip(self._pos_integral + pe * dt, -2, 2)
            u = kp_pos * pe + ki_pos * self._pos_integral + kd_pos * ve
            ae, we = sp_att - att, sp_omega - omega
            self._att_integral = np.clip(self._att_integral + ae * dt, -1, 1)
            rates = kp_att * ae + ki_att * self._att_integral + kd_att * we
            self._command = {
                "thrust": max(thrust_ff + u[2], 0.0),
                "roll_rate": rates[0],
                "pitch_rate": rates[1],
                "yaw_rate": rates[2],
                "iteration": self._iterations,
            }

    def get_command(self) -> Optional[dict]:
        with self._lock:
            return dict(self._command) if self._command else None

    def get_execution_times(self) -> np.ndarray:
        with self._lock:
            return np.asarray(self._exec_times[-1000:], float)

    def get_stats(self) -> dict:
        et = np.asarray(self._exec_times) if self._exec_times else np.zeros(1)
        elapsed = max(time.perf_counter() - self._t0, 1e-9)
        return {
            "iteration_count": self._iterations,
            "missed_deadlines": self._missed,
            "mean_execution_time_ms": float(et.mean() * 1e3),
            "max_execution_time_ms": float(et.max() * 1e3),
            "min_execution_time_ms": float(et.min() * 1e3),
            "jitter_rms_ms": float(et.std() * 1e3),
            "frequency_actual_hz": self._iterations / elapsed,
            "frequency_target_hz": self.frequency_hz,
            "interval_jitter_rms_ms": 0.0,
            "running": self._running,
            "success_rate": (self._iterations - self._missed)
            / max(self._iterations, 1),
        }


def create_control_loop(frequency_hz: float = 400.0, prefer_native: bool = True):
    """(reference create_control_loop, pyx:487)"""
    if prefer_native and native_available():
        return RealTimeControlLoop(frequency_hz)
    return PythonControlLoop(frequency_hz)
