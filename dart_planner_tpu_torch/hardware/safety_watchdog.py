"""Heartbeat-timeout safety watchdog (PyTorch counterpart of
:mod:`dart_planner_tpu.hardware.safety_watchdog`).

A framework-free copy of the reference ``hardware/safety_watchdog.py``,
over the port's ``HeartbeatMonitor``: monitors a heartbeat source and
triggers emergency landing through the vehicle interface on loss
(:50-127).
"""

from __future__ import annotations

import asyncio
from typing import Callable, Optional

from dart_planner_tpu_torch.comms.heartbeat import HeartbeatConfig, HeartbeatMonitor
from dart_planner_tpu_torch.hardware.vehicle_io import VehicleIO


class SafetyWatchdog:
    """(reference safety_watchdog.py:50-157)"""

    def __init__(
        self,
        vehicle: VehicleIO,
        config: Optional[HeartbeatConfig] = None,
        on_emergency: Optional[Callable[[], None]] = None,
    ):
        self.vehicle = vehicle
        self.monitor = HeartbeatMonitor(
            config or HeartbeatConfig(), emergency_callback=self._emergency
        )
        self.on_emergency = on_emergency
        self.emergency_count = 0
        self._emergency_task: Optional[asyncio.Task] = None

    def start(self) -> None:
        self.monitor.start_monitoring()

    def stop(self) -> None:
        self.monitor.stop_monitoring()

    def heartbeat(self) -> None:
        """Feed the watchdog (call from the telemetry/comms loop)."""
        self.monitor.heartbeat_received_sync()

    def _emergency(self) -> None:
        """Heartbeat lost -> emergency landing (reference :68-127)."""
        self.emergency_count += 1
        if self.on_emergency is not None:
            self.on_emergency()
        try:
            loop = asyncio.get_event_loop()
            self._emergency_task = loop.create_task(self._emergency_sequence())
        except RuntimeError:
            asyncio.run(self._emergency_sequence())

    async def _emergency_sequence(self) -> None:
        await self.vehicle.emergency_stop()

    def get_status(self) -> dict:
        return {
            **self.monitor.get_status(),
            "emergency_count": self.emergency_count,
        }
