"""Hardware mission orchestration: ``start_mission`` over any VehicleIO
(PyTorch counterpart of :mod:`dart_planner_tpu.hardware.mission`).

Parity analog of the reference's
``PixhawkInterface.start_mission(waypoints)``
(the reference's hardware/pixhawk_interface.py:297-314, "PX"), which
gathers four asyncio loops against the vehicle:

- 400 Hz optimized control loop (PX:372-420): state → trajectory
  interpolation → ``compute_control_from_fast_state`` → body-rate
  target, with the motor-saturation watchdog (PX:408-411),
- 50 Hz planning loop (PX:494-522) with the 8 ms planning-time warning,
- 10 Hz telemetry loop (PX:650-676),
- safety monitor (PX:678-705): velocity/altitude envelope, heartbeat
  loss, telemetry gap → ``_trigger_failsafe`` → land (PX:707-713).

Differences from the reference, by design:

- the runner binds over the ``VehicleIO`` ABC, not a hardwired MAVLink
  connection: a vehicle that owns its own inner loop (e.g.
  ``SimulatedVehicleIO.step`` runs smoother→controller→physics
  in-process) is stepped directly, while a raw transport vehicle
  (``MavlinkVehicleIO``) gets the runner's own smoother + geometric
  controller and receives body-rate targets — the reference can only do
  the latter, against pymavlink specifically.
- loops are paced by the quartic scheduler (`runtime.integration`) with
  per-task deadline/overrun accounting instead of four hand-rolled
  ``while``/``sleep`` loops, so the mission inherits the scheduler's
  jitter stats and auto-disable policy.
- waypoints are flown in sequence with an arrival tolerance; the
  reference silently drops every intermediate waypoint
  (``self.planner.set_goal(waypoints[-1])``, PX:304).
- the planner is the SE(3) MPC facade (`planning.se3_mpc`) on the
  runner's device, which on the card solves each replan in kernel B1
  (``ops/cuda_mpc.py``); the reference's 8 ms planning-warning threshold
  (PX:46) is kept as the watchdog bar.

The runner, its planner and the runner-owned control stack live on one
device (default: the vehicle's, else the card). Every read of a tensor on
the host is an explicit ``.cpu()`` or ``.item()``.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from dart_planner_tpu_torch.common.device import resolve_device
from dart_planner_tpu_torch.common.logging_config import get_logger
from dart_planner_tpu_torch.common.types import DroneState
from dart_planner_tpu_torch.control import geometric
from dart_planner_tpu_torch.control.smoother import (
    SmootherConfig,
    SmootherState,
    get_desired_state,
    update_trajectory,
)
from dart_planner_tpu_torch.hardware.motor_mixer import MotorMixer
from dart_planner_tpu_torch.hardware.vehicle_io import VehicleIO
from dart_planner_tpu_torch.runtime.scheduler import QuarticTask, TaskPriority
from dart_planner_tpu_torch.runtime.integration import RealTimeManager
from dart_planner_tpu_torch.security.validation import validate_waypoints

logger = get_logger("hardware.mission")


@dataclass
class MissionConfig:
    """(PX HardwareConfig:22-47 + safety limits PX:698-705)"""

    control_frequency: float = 400.0  # Hz (PX:33)
    planning_frequency: float = 50.0  # Hz (PX:34)
    telemetry_frequency: float = 10.0  # Hz (PX:35)
    safety_frequency: float = 10.0  # Hz (PX checks at 1 Hz, :696)
    planning_warning_ms: float = 8.0  # PX:46
    max_velocity: float = 15.0  # m/s (PX:702)
    max_altitude: float = 50.0  # m (PX:705)
    heartbeat_timeout_s: float = 0.5  # PX:689 (500 ms comms default)
    saturation_watchdog_threshold: int = 50  # events (PX:408-411)
    waypoint_tolerance: float = 0.8  # m arrival radius
    mission_timeout_s: float = 120.0  # overall wall-clock guard


@dataclass
class MissionState:
    """Mutable run bookkeeping (PX performance_stats + flags)."""

    active: bool = False
    emergency: bool = False
    failsafe_reason: Optional[str] = None
    waypoint_index: int = 0
    waypoints_reached: int = 0
    planning_times_ms: List[float] = field(default_factory=list)
    planning_failures: int = 0
    telemetry_rows: List[Dict[str, Any]] = field(default_factory=list)
    commands_sent: int = 0


class MissionRunner:
    """The ``start_mission`` orchestrator (PX:297-314).

    Gathers control/planning/telemetry/safety loops over a connected,
    armed ``VehicleIO`` and flies a waypoint list to completion (or to
    failsafe). Use :func:`start_mission` for the one-call form.
    """

    def __init__(
        self,
        vehicle: VehicleIO,
        config: Optional[MissionConfig] = None,
        planner: Optional[Any] = None,
        controller_config: Optional[geometric.GeometricConfig] = None,
        device=None,
    ):
        from dart_planner_tpu_torch.planning.se3_mpc import SE3MPCPlanner

        self.vehicle = vehicle
        self.device = resolve_device(
            device if device is not None else getattr(vehicle, "device", None)
        )
        self.config = config or MissionConfig()
        self.planner = planner or SE3MPCPlanner(device=self.device)
        self.mixer = MotorMixer()
        self.state = MissionState()
        self._waypoints: List[np.ndarray] = []
        self._mission_done = asyncio.Event()
        self._last_state_time = 0.0
        # runner-owned control stack for transport-only vehicles
        # (vehicles with their own inner loop expose ``step``; PX always
        # owns the stack because pymavlink is transport-only)
        self._vehicle_has_step = hasattr(vehicle, "step")
        self._ctrl_config = controller_config or geometric.GeometricConfig()
        self._ctrl_state = geometric.ControllerState.zeros(
            self._ctrl_config, device=self.device
        )
        self._smoother_config = SmootherConfig(failsafe_timeout=60.0)
        self._smoother_state = SmootherState.zeros(
            getattr(getattr(self.planner, "config", None), "horizon", 20),
            device=self.device,
        )
        self._zero = torch.zeros((), device=self.device)
        self._t0 = 0.0

    # ------------------------------------------------------------ loops
    def _sim_now(self) -> float:
        """Trajectory timeline: the vehicle's own clock if it has one."""
        if self._vehicle_has_step:
            return float(self.vehicle.sim_time)
        return time.time() - self._t0

    def _check_arrival(self, state: DroneState) -> None:
        """Waypoint sequencing at control rate — a fast fly-through must
        not slip between two 50 Hz planning ticks (the reference only
        ever aims at waypoints[-1], PX:304, so it never has this race).
        Once the mission is done, a later check (the planning tick's, after
        the control tick's) counts nothing: the JAX package's counts the
        final waypoint again, and its report then calls the mission
        incomplete."""
        if self._mission_done.is_set():
            return
        pos = state.position.cpu().numpy()
        goal = self._waypoints[self.state.waypoint_index]
        if np.linalg.norm(pos - goal) < self.config.waypoint_tolerance:
            self.state.waypoints_reached += 1
            if self.state.waypoint_index + 1 < len(self._waypoints):
                self.state.waypoint_index += 1
                logger.info(
                    "waypoint %d reached; next", self.state.waypoint_index
                )
            else:
                logger.info("final waypoint reached; mission complete")
                self._mission_done.set()

    def _control_tick(self) -> None:
        """400 Hz tick (PX:372-420)."""
        if not self.state.active or self.state.emergency:
            return
        if self._vehicle_has_step:
            # in-process plant: the vehicle's step runs
            # smoother -> controller -> physics itself
            state = self.vehicle.step()
            self.state.commands_sent += 1
            cmd = getattr(self.vehicle, "last_command", None)
            if cmd is not None:
                self.mixer.mix_commands(cmd.thrust.item(), cmd.torque.cpu().numpy())
            self._check_arrival(state)
            return
        state = self.vehicle.get_state()
        if state is None:
            return
        self._check_arrival(state)
        self._last_state_time = time.time()
        state = _on(state, self.device)
        (pos_d, vel_d, acc_d), self._smoother_state = get_desired_state(
            self._smoother_config, self._smoother_state, self._sim_now(), state
        )
        sp = geometric.ControlSetpoint(
            position=pos_d,
            velocity=vel_d,
            acceleration=acc_d,
            yaw=self._zero,
            yaw_rate=self._zero,
        )
        dt = 1.0 / self.config.control_frequency
        # functional equivalent of compute_control_from_fast_state ->
        # _convert_to_body_rate_cmd (PX:391-416)
        brc, self._ctrl_state = geometric.compute_body_rate_command(
            self._ctrl_config, self._ctrl_state, state, sp, dt
        )
        # motor-saturation watchdog input (PX:408-411)
        thrust_n = brc.thrust.item() * self._ctrl_config.max_thrust
        self.mixer.mix_commands(thrust_n, np.zeros(3))
        send = getattr(self.vehicle, "send_body_rate_target", None)
        if send is not None:
            send(brc)
            self.state.commands_sent += 1

    async def _planning_tick(self) -> None:
        """50 Hz replan toward the current waypoint (PX:494-522)."""
        if not self.state.active or self.state.emergency:
            return
        state = self.vehicle.get_state()
        if state is None:
            return
        goal = self._waypoints[self.state.waypoint_index]
        t0 = time.perf_counter()
        try:
            traj = self.planner.plan_trajectory(state, goal)
        except Exception as e:  # PX:515-517
            logger.error("planning failure: %s", e)
            self.state.planning_failures += 1
            return
        plan_ms = (time.perf_counter() - t0) * 1e3
        self.state.planning_times_ms.append(plan_ms)
        if plan_ms > self.config.planning_warning_ms:
            logger.warning("planning time exceeded: %.1f ms", plan_ms)
        # shift the trajectory onto the vehicle's timeline
        t_now = self._sim_now()
        traj = traj.replace(
            timestamps=traj.timestamps - traj.timestamps[..., 0] + t_now
        )
        await self.vehicle.send_trajectory(traj)
        if not self._vehicle_has_step:
            self._smoother_state = update_trajectory(
                self._smoother_config,
                self._smoother_state,
                traj.replace(**{
                    k: getattr(traj, k).to(self.device)
                    for k in ("timestamps", "positions", "velocities", "accelerations")
                }),
                t_now,
            )
        # arrival is also checked here for vehicles whose state only
        # refreshes on polls (the control tick does the fast check)
        self._check_arrival(state)

    def _telemetry_tick(self) -> None:
        """10 Hz status row (PX:650-676)."""
        state = self.vehicle.get_state()
        if state is None:
            return
        times = self.state.planning_times_ms[-50:]
        self.state.telemetry_rows.append(
            {
                "t": self._sim_now(),
                "position": state.position.cpu().tolist(),
                "waypoint_index": self.state.waypoint_index,
                "avg_planning_ms": float(np.mean(times)) if times else 0.0,
                "armed": self.vehicle.get_status().get("armed", False),
            }
        )

    async def _safety_tick(self) -> None:
        """Envelope + heartbeat + saturation watchdog (PX:678-711)."""
        if not self.state.active or self.state.emergency:
            return
        state = self.vehicle.get_state()
        if state is not None:
            v = torch.linalg.vector_norm(state.velocity).item()
            if v > self.config.max_velocity:
                await self._trigger_failsafe(
                    f"velocity exceeded limit: {v:.1f} m/s"
                )
                return
            z = state.position[..., 2].item()
            if z > self.config.max_altitude:
                await self._trigger_failsafe(
                    f"altitude exceeded limit: {z:.1f} m"
                )
                return
        hb_age = getattr(self.vehicle, "heartbeat_age", None)
        if hb_age is not None and hb_age() > self.config.heartbeat_timeout_s:
            await self._trigger_failsafe("heartbeat lost")
            return
        if (
            self.mixer.saturation_events
            > self.config.saturation_watchdog_threshold
        ):
            await self._trigger_failsafe("frequent motor saturation events")

    async def _trigger_failsafe(self, reason: str) -> None:
        """(PX:707-713)"""
        if self.state.emergency:
            return
        logger.critical("failsafe triggered: %s", reason)
        self.state.emergency = True
        self.state.failsafe_reason = reason
        self._mission_done.set()

    # ------------------------------------------------------------ public
    async def start_mission(self, waypoints) -> Dict[str, Any]:
        """Fly the waypoint list; returns the performance report
        (PX:293-315 + PX:716-745). The vehicle must be connected; the
        runner arms it if needed."""
        if not self.vehicle.get_status().get("connected"):
            raise RuntimeError("vehicle not connected")
        self._waypoints = validate_waypoints(waypoints)
        if not self.vehicle.get_status().get("armed"):
            await self.vehicle.arm()
        self.state = MissionState(active=True)
        self._mission_done = asyncio.Event()
        self.mixer.saturation_events = 0
        self._t0 = time.time()
        self.planner.set_goal(self._waypoints[0])

        manager = RealTimeManager()
        manager.set_control_function(
            self._control_tick, frequency_hz=self.config.control_frequency
        )
        manager.set_planning_function(
            self._planning_tick, frequency_hz=self.config.planning_frequency
        )
        manager.set_safety_function(
            self._safety_tick,  # async: the scheduler tracks it in-flight
            frequency_hz=self.config.safety_frequency,
        )
        manager.add_custom_task(
            QuarticTask(
                name="telemetry",
                func=self._telemetry_tick,
                frequency_hz=self.config.telemetry_frequency,
                priority=TaskPriority.LOW,
            )
        )
        # a busy CI box overruns the 400 Hz slot; a slow control loop is
        # still safer than a disabled one (same policy as apps/edge.py)
        manager.control_task.max_consecutive_overruns = 10**9
        manager.planning_task.max_consecutive_overruns = 10**9

        await manager.start()
        try:
            await asyncio.wait_for(
                self._mission_done.wait(),
                timeout=self.config.mission_timeout_s,
            )
        except asyncio.TimeoutError:
            self.state.failsafe_reason = "mission timeout"
        finally:
            self.state.active = False
            await manager.stop()
            if self.state.emergency:
                await self.vehicle.land()  # PX:713
        report = self.get_performance_report()
        report["scheduler"] = manager.get_stats()
        return report

    async def stop_mission(self) -> None:
        """Cancel + land (PX:317-324)."""
        self.state.active = False
        self._mission_done.set()
        await self.vehicle.land()

    def get_performance_report(self) -> Dict[str, Any]:
        """(PX:716-745)"""
        times = np.asarray(self.state.planning_times_ms)
        report: Dict[str, Any] = {
            "mission_complete": (
                self.state.waypoints_reached == len(self._waypoints)
                and not self.state.emergency
            ),
            "waypoints_reached": self.state.waypoints_reached,
            "waypoints_total": len(self._waypoints),
            "failsafe_reason": self.state.failsafe_reason,
            "commands_sent": self.state.commands_sent,
            "planning_failures": self.state.planning_failures,
            "telemetry_rows": len(self.state.telemetry_rows),
            "saturation_events": self.mixer.saturation_events,
        }
        if times.size:
            report.update(
                avg_planning_time_ms=float(times.mean()),
                max_planning_time_ms=float(times.max()),
                p95_planning_time_ms=float(np.percentile(times, 95)),
            )
        return report


def _on(state: DroneState, device) -> DroneState:
    """``state`` with every field on ``device`` (no copy where it is)."""
    return DroneState(
        timestamp=state.timestamp.to(device),
        position=state.position.to(device),
        velocity=state.velocity.to(device),
        attitude=state.attitude.to(device),
        angular_velocity=state.angular_velocity.to(device),
    )


async def start_mission(
    vehicle: VehicleIO,
    waypoints,
    config: Optional[MissionConfig] = None,
    planner: Optional[Any] = None,
    device=None,
) -> Dict[str, Any]:
    """One-call mission: build a runner and fly (PX:293-315)."""
    runner = MissionRunner(vehicle, config=config, planner=planner, device=device)
    return await runner.start_mission(waypoints)
