"""Edge control loop (PyTorch counterpart of :mod:`dart_planner_tpu.apps.edge`).

Port of the reference ``edge/main_improved.py`` ("E"): a high-rate
control loop that polls the cloud for trajectories at ~10 Hz over ZMQ
(E:97-118), splices them with the trajectory smoother (E:111), runs the
geometric controller per tick (E:140-147), steps the simulated vehicle
physics (E:150), and keeps CSV-style logs + frequency stats (E:198-238).
The tiered failsafe (NOMINAL/DEGRADED/AUTONOMOUS/EMERGENCY keyed on
connection quality) follows edge/onboard_autonomous_controller.py:19-64.

The vehicle ticks on one device (``device``, default: the card); a
received plan becomes a ``Trajectory`` there, and the state sent to the
cloud and each log row are one host read each. ``client`` takes an
already-built request client (any
:class:`~dart_planner_tpu_torch.comms.zmq_transport.RequestClient`) in
place of the ``ZmqClient`` the controller builds by default.
"""

from __future__ import annotations

import asyncio
import enum
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from dart_planner_tpu_torch.common.device import to_host
from dart_planner_tpu_torch.common.errors import (
    CommunicationError,
    ValidationError,
)
from dart_planner_tpu_torch.common.logging_config import get_logger
from dart_planner_tpu_torch.security.validation import (
    SafetyLimits,
    validate_trajectory,
)
from dart_planner_tpu_torch.common.timing import TimingConfig, TimingManager
from dart_planner_tpu_torch.common.types import Trajectory
from dart_planner_tpu_torch.comms import SecureSerializer, ZmqClient
from dart_planner_tpu_torch.comms.zmq_transport import RequestClient
from dart_planner_tpu_torch.control import smoother
from dart_planner_tpu_torch.hardware.simulated_vehicle import SimulatedVehicleIO
from dart_planner_tpu_torch.runtime.integration import (
    RealTimeManager,
    control_loop_task,
    planning_loop_task,
    safety_task,
)

logger = get_logger("apps.edge")


class FailsafeTier(enum.Enum):
    """(reference edge/onboard_autonomous_controller.py:19-64)"""

    NOMINAL = "nominal"  # cloud trajectories fresh
    DEGRADED = "degraded"  # stale but recent trajectories
    AUTONOMOUS = "autonomous"  # no cloud; hold/loiter locally
    EMERGENCY = "emergency"  # descend now


@dataclass
class EdgeConfig:
    """(E:34-39 TimingConfig usage + failsafe thresholds)"""

    control_frequency: float = 200.0  # Hz (reference demo: 1 kHz; CPU-bound here)
    comms_frequency: float = 10.0  # Hz
    cloud_host: str = "localhost"
    cloud_port: int = 5555
    degraded_after_s: float = 1.0
    autonomous_after_s: float = 3.0
    emergency_after_s: float = 10.0
    # Safety envelope applied to every trajectory received over ZMQ
    # before it reaches the smoother (reference validation.py:288-322 —
    # the reference builds the validator but never wires it into its
    # edge loop; here rejection is part of ingestion). Bounds follow
    # the MPC's own envelope (se3_mpc.py: v<=10 m/s, a<=15 m/s^2) with
    # headroom, not the reference's tighter defaults, so legitimate
    # aggressive plans are not refused.
    trajectory_limits: SafetyLimits = SafetyLimits(
        min_altitude=-1.0,
        max_horizontal_velocity=15.0,
        max_vertical_velocity=15.0,
        max_horizontal_acceleration=25.0,
        max_vertical_acceleration=25.0,
        max_segment_length=20.0,
        continuity_tolerance=0.5,
    )


class EdgeController:
    """(E:18-238)"""

    def __init__(
        self,
        config: Optional[EdgeConfig] = None,
        serializer: Optional[SecureSerializer] = None,
        vehicle: Optional[SimulatedVehicleIO] = None,
        client: Optional[RequestClient] = None,
        device=None,
    ):
        self.config = config or EdgeConfig()
        self.vehicle = vehicle or SimulatedVehicleIO(
            {"control_dt": 1.0 / self.config.control_frequency}, device=device
        )
        self.client = client if client is not None else ZmqClient(
            host=self.config.cloud_host,
            port=self.config.cloud_port,
            timeout_ms=500,
            serializer=serializer,
        )
        self.timing = TimingManager(
            TimingConfig(
                control_frequency=self.config.control_frequency,
                planning_frequency=self.config.comms_frequency,
            )
        )
        self.tier = FailsafeTier.AUTONOMOUS
        self.last_cloud_ok = 0.0
        self.rejected_trajectories = 0
        self.log_rows: List[Dict[str, Any]] = []
        self._running = False

    def _update_tier(self, now: float) -> None:
        age = now - self.last_cloud_ok
        if age < self.config.degraded_after_s:
            self.tier = FailsafeTier.NOMINAL
        elif age < self.config.autonomous_after_s:
            self.tier = FailsafeTier.DEGRADED
        elif age < self.config.emergency_after_s:
            self.tier = FailsafeTier.AUTONOMOUS
        else:
            self.tier = FailsafeTier.EMERGENCY

    def _exchange_with_cloud(self) -> Optional[Trajectory]:
        """Blocking ZMQ round trip (E:97-118). Pure I/O — runs on a
        worker thread; the smoother splice happens back on the event
        loop (``_apply_trajectory``) so vehicle state is single-threaded."""
        state = self.vehicle.get_state()
        # one host read: timestamp, position, velocity
        row = to_host(
            torch.cat([state.timestamp.reshape(1), state.position, state.velocity]),
            np.float32,
        )
        try:
            self.client.send_request(
                "update_state",
                {
                    "timestamp": float(row[0]),
                    "position": row[1:4],
                    "velocity": row[4:7],
                },
            )
            out = self.client.send_request("get_trajectory")
        except CommunicationError:
            return None
        if not out or not out.get("available"):
            return None
        try:
            # Trust boundary: the payload is HMAC-authenticated transport
            # but its CONTENT is still unvalidated — a compromised or
            # buggy cloud must not be able to command an out-of-envelope
            # or discontinuous flight path.
            validate_trajectory(
                out["timestamps"],
                out["positions"],
                out["velocities"],
                out["accelerations"],
                limits=self.config.trajectory_limits,
            )
        except (ValidationError, KeyError) as e:
            logger.warning("rejected cloud trajectory: %s", e)
            self.rejected_trajectories += 1
            return None
        def on_vehicle(name):
            arr = np.array(out[name], np.float32)  # a writable host copy
            return torch.as_tensor(arr, device=self.vehicle.device)

        return Trajectory(
            timestamps=on_vehicle("timestamps"),
            positions=on_vehicle("positions"),
            velocities=on_vehicle("velocities"),
            accelerations=on_vehicle("accelerations"),
        )

    def _apply_trajectory(self, traj: Trajectory) -> None:
        """Splice through the smoother (E:111); timeline is sim time."""
        self.vehicle.smoother_state = smoother.update_trajectory(
            self.vehicle.smoother_config,
            self.vehicle.smoother_state,
            traj,
            torch.tensor(
                self.vehicle.sim_time, dtype=torch.float32, device=self.vehicle.device
            ),
        )
        self.last_cloud_ok = time.time()

    def _fetch_trajectory(self) -> bool:
        """Synchronous exchange+apply (tests / non-scheduled callers)."""
        traj = self._exchange_with_cloud()
        if traj is None:
            return False
        self._apply_trajectory(traj)
        return True

    async def run(self, duration: float = 10.0) -> Dict[str, Any]:
        """Main loop (E:86-192) on the real-time integration layer: the
        control/planning/safety loops are registered through the
        ``@control_loop_task``/``@planning_loop_task``/``@safety_task``
        decorators onto a ``RealTimeManager`` (reference
        real_time_integration.py:413-491 + edge/main_quartic_improved.py),
        which paces them at their configured rates with deadline/overrun
        accounting. Returns run statistics (E:198-238)."""
        await self.vehicle.connect()
        await self.vehicle.arm()
        self._running = True
        # grace period: tier timers start at launch, not epoch
        self.last_cloud_ok = time.time()
        manager = RealTimeManager()
        emergency = asyncio.Event()
        ticks = 0

        @control_loop_task(
            frequency_hz=self.config.control_frequency, manager=manager
        )
        def control_tick():
            nonlocal ticks
            state = self.vehicle.step()
            ticks += 1
            if ticks % 20 == 0:
                t, x, y, z = to_host(
                    torch.cat([state.timestamp.reshape(1), state.position])
                )
                self.log_rows.append(
                    {
                        "t": float(t),
                        "x": float(x),
                        "y": float(y),
                        "z": float(z),
                        "tier": self.tier.value,
                    }
                )

        @planning_loop_task(
            frequency_hz=self.config.comms_frequency, manager=manager
        )
        async def comms_exchange():
            # socket poll on a worker thread: the scheduler keeps the
            # control tick running while this is in flight
            loop = asyncio.get_running_loop()
            traj = await loop.run_in_executor(None, self._exchange_with_cloud)
            if traj is not None:
                self._apply_trajectory(traj)

        # comms timeouts overrun the 10 Hz slot by design; loss of cloud
        # contact is handled by the tier failsafe, not task auto-disable
        manager.planning_task.max_consecutive_overruns = 10**9
        # never silently stop flying the vehicle: a degraded control loop
        # is strictly safer than no control loop (overruns still counted)
        manager.control_task.max_consecutive_overruns = 10**9

        @safety_task(frequency_hz=100.0, manager=manager)
        def tier_monitor():
            self._update_tier(time.time())
            if self.tier is FailsafeTier.EMERGENCY:
                emergency.set()

        t_start = time.time()
        await manager.start()
        try:
            stop_waits = [
                asyncio.create_task(asyncio.sleep(duration)),
                asyncio.create_task(emergency.wait()),
            ]
            done, pending = await asyncio.wait(
                stop_waits, return_when=asyncio.FIRST_COMPLETED
            )
            for p in pending:
                p.cancel()
        finally:
            await manager.stop()
        if emergency.is_set():
            await self.vehicle.emergency_stop()
        elapsed = time.time() - t_start
        return {
            "ticks": ticks,
            "achieved_hz": ticks / max(elapsed, 1e-9),
            "tier": self.tier.value,
            "final_position": to_host(self.vehicle.get_state().position, np.float32),
            "log_rows": len(self.log_rows),
            "scheduler": manager.get_stats(),
        }

    def stop(self) -> None:
        self._running = False
        self.client.close()


async def main(duration: float = 10.0, device=None) -> Dict[str, Any]:
    """(E:241-243)"""
    edge = EdgeController(device=device)
    try:
        return await edge.run(duration)
    finally:
        edge.stop()
