"""Motor latency calibration by step response (PyTorch counterpart
of :mod:`dart_planner_tpu.hardware.motor_calibration`).

Parity port of the reference ``MotorLatencyCalibrator``
(the reference's hardware/motor_latency_calibration.py,
"MLC"): send a throttle/attitude step through a hardware adapter, poll
until the measured state responds past a threshold, and derive latency
statistics — mean/std/min/max, a 95% confidence interval, a recommended
max-latency budget, and a quality grade (MLC:224-314).

The adapter contract is duck-typed and test-friendly:
``send_test_command(dict)`` applies a step and ``get_response_state() ->
dict`` reads whatever channel the command targets.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


@dataclass
class LatencyMeasurement:
    """One step-response sample (MLC:20-29)."""

    sample_index: int
    command_type: str
    latency_ms: float
    timestamp: float


@dataclass
class CalibrationResult:
    """Aggregate calibration output (MLC:32-44)."""

    mean_latency_ms: float
    std_latency_ms: float
    min_latency_ms: float
    max_latency_ms: float
    confidence_interval_ms: tuple
    recommended_max_latency_ms: float
    quality: str  # "excellent" | "good" | "acceptable" | "poor"
    num_samples: int
    measurements: List[LatencyMeasurement] = field(default_factory=list)


DEFAULT_CONFIG: Dict[str, Any] = {
    # MLC:64-78
    "num_samples": 20,
    "command_type": "throttle",
    "step_magnitude": 0.2,
    "response_threshold": 0.05,
    "poll_interval_s": 0.001,
    "timeout_s": 0.5,
    "settle_time_s": 0.05,
}


class MotorLatencyCalibrator:
    """Step-response latency measurement (MLC:46-378)."""

    def __init__(self, hardware_adapter, config: Optional[Dict[str, Any]] = None):
        self.adapter = hardware_adapter
        self.config = {**DEFAULT_CONFIG, **(config or {})}
        self.measurements: List[LatencyMeasurement] = []

    # -- measurement ---------------------------------------------------
    def calibrate_latency(
        self, num_samples: Optional[int] = None
    ) -> CalibrationResult:
        """Run N step-response measurements and analyze (MLC:80-112)."""
        n = num_samples or int(self.config["num_samples"])
        self.measurements = []
        for i in range(n):
            m = self._perform_single_measurement(i)
            if m is not None:
                self.measurements.append(m)
            time.sleep(self.config["settle_time_s"])
        if not self.measurements:
            return CalibrationResult(
                mean_latency_ms=float("nan"),
                std_latency_ms=float("nan"),
                min_latency_ms=float("nan"),
                max_latency_ms=float("nan"),
                confidence_interval_ms=(float("nan"), float("nan")),
                recommended_max_latency_ms=float("nan"),
                quality="poor",
                num_samples=0,
            )
        return self._analyze()

    def _perform_single_measurement(
        self, sample_index: int
    ) -> Optional[LatencyMeasurement]:
        """One step + response poll (MLC:114-158)."""
        ctype = self.config["command_type"]
        initial = dict(self.adapter.get_response_state())
        cmd = {
            "type": ctype,
            "magnitude": self.config["step_magnitude"],
        }
        t0 = time.perf_counter()
        self.adapter.send_test_command(cmd)
        deadline = t0 + self.config["timeout_s"]
        thresh = self.config["response_threshold"]
        key = "throttle" if ctype == "throttle" else "attitude"
        while time.perf_counter() < deadline:
            state = self.adapter.get_response_state()
            if abs(state.get(key, 0.0) - initial.get(key, 0.0)) >= thresh:
                return LatencyMeasurement(
                    sample_index=sample_index,
                    command_type=ctype,
                    latency_ms=(time.perf_counter() - t0) * 1e3,
                    timestamp=time.time(),
                )
            time.sleep(self.config["poll_interval_s"])
        return None  # no response within timeout

    # -- analysis ------------------------------------------------------
    def _analyze(self) -> CalibrationResult:
        """Statistics + CI + budget + quality (MLC:224-314)."""
        lat = np.array([m.latency_ms for m in self.measurements])
        mean, std = float(lat.mean()), float(lat.std(ddof=1)) if len(lat) > 1 else 0.0
        # 95% CI on the mean (normal approximation, MLC:269-281)
        half = 1.96 * std / np.sqrt(len(lat)) if len(lat) > 1 else 0.0
        ci = (mean - half, mean + half)
        # budget = mean + 3 sigma, floored at 1 ms (MLC:283-292)
        budget = max(mean + 3.0 * std, 1.0)
        quality = self._quality(lat, std)
        return CalibrationResult(
            mean_latency_ms=mean,
            std_latency_ms=std,
            min_latency_ms=float(lat.min()),
            max_latency_ms=float(lat.max()),
            confidence_interval_ms=ci,
            recommended_max_latency_ms=budget,
            quality=quality,
            num_samples=len(lat),
            measurements=list(self.measurements),
        )

    def _quality(self, lat: np.ndarray, std: float) -> str:
        """Grade (MLC:294-314): sample count, spread, and magnitude."""
        n_ok = len(lat) >= 0.8 * self.config["num_samples"]
        mean = lat.mean()
        if n_ok and std < 0.1 * max(mean, 1e-9) and mean < 20.0:
            return "excellent"
        if n_ok and std < 0.25 * max(mean, 1e-9) and mean < 50.0:
            return "good"
        if len(lat) >= 0.5 * self.config["num_samples"]:
            return "acceptable"
        return "poor"

    def get_calibration_report(self) -> Dict[str, Any]:
        """(MLC:344-378)"""
        if not self.measurements:
            return {"status": "not_calibrated"}
        r = self._analyze()
        return {
            "status": "calibrated",
            "mean_latency_ms": r.mean_latency_ms,
            "std_latency_ms": r.std_latency_ms,
            "confidence_interval_ms": r.confidence_interval_ms,
            "recommended_max_latency_ms": r.recommended_max_latency_ms,
            "quality": r.quality,
            "num_samples": r.num_samples,
        }


def calibrate_motor_latency(
    hardware_adapter, config: Optional[Dict[str, Any]] = None
) -> CalibrationResult:
    """Convenience wrapper (MLC:380)."""
    return MotorLatencyCalibrator(hardware_adapter, config).calibrate_latency()
