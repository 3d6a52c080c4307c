"""Pure-software vehicle (PyTorch counterpart of
:mod:`dart_planner_tpu.hardware.simulated_vehicle`).

Runs the trajectory smoother, the geometric controller and the rigid-body
physics in-process on one device (default: the card): ``send_trajectory``
feeds the smoother, ``step(dt)`` advances the closed loop one control
tick. Registered as ``"simulated"`` in the
:class:`~dart_planner_tpu_torch.hardware.vehicle_io.VehicleIOFactory`.

The tick is plain eager PyTorch: one vehicle's smoother, controller and
plant are a few hundred small ops, launched one by one on the card.
Kernel B2 (``ops/cuda_rollout.py``) runs the same controller and plant
for a fleet, but it returns no command, and the mission's motor mixer
reads each tick's command (``last_command``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dart_planner_tpu_torch.common.device import resolve_device
from dart_planner_tpu_torch.common.types import DroneState, Trajectory
from dart_planner_tpu_torch.control import geometric
from dart_planner_tpu_torch.control.smoother import (
    SmootherConfig,
    SmootherState,
    get_desired_state,
    update_trajectory,
)
from dart_planner_tpu_torch.hardware.vehicle_io import VehicleIO, VehicleIOFactory
from dart_planner_tpu_torch.sim import physics as phys


class SimulatedVehicleIO(VehicleIO):
    """In-process vehicle. ``device`` (or the config's ``"device"``) places
    its state; without either it runs on the card."""

    def __init__(self, config: Optional[dict] = None, device=None):
        super().__init__(config)
        cfg = config or {}
        self.device = resolve_device(device if device is not None else cfg.get("device"))
        self.physics = phys.PhysicsConfig(
            mass=cfg.get("mass", 1.5), max_thrust=cfg.get("max_thrust", 25.0)
        )
        self.controller_config = geometric.GeometricConfig(
            mass=self.physics.mass, max_thrust=self.physics.max_thrust
        )
        horizon = cfg.get("horizon", 20)
        # long failsafe: one-shot trajectories (takeoff/land) must finish
        # without 10 Hz re-feeds; real missions replan far faster anyway
        self.smoother_config = SmootherConfig(failsafe_timeout=60.0)
        self._reset_state(cfg.get("initial_position", (0.0, 0.0, 0.0)), horizon)
        self.sim_time = 0.0
        self.control_dt = cfg.get("control_dt", 0.0025)  # 400 Hz
        self.last_command = None
        self._zero = torch.zeros((), device=self.device)

    def _reset_state(self, position, horizon: int) -> None:
        self.rb = phys.RigidBodyState.from_drone_state(
            DroneState.create(position=position, device=self.device)
        )
        self.ctrl_state = geometric.ControllerState.zeros(
            self.controller_config, device=self.device
        )
        self.smoother_state = SmootherState.zeros(horizon, device=self.device)

    # -- VehicleIO interface --
    async def connect(self) -> bool:
        self.connected = True
        return True

    async def disconnect(self) -> None:
        self.connected = False

    def get_state(self) -> Optional[DroneState]:
        return self.rb.to_drone_state(self.sim_time)

    async def send_trajectory(self, trajectory: Trajectory) -> bool:
        if not self.armed:
            return False
        self.smoother_state = update_trajectory(
            self.smoother_config, self.smoother_state, trajectory, self.sim_time
        )
        return True

    async def arm(self) -> bool:
        self.armed = True
        return True

    async def disarm(self) -> bool:
        self.armed = False
        return True

    async def takeoff(self, altitude: float) -> bool:
        if not self.armed:
            return False
        p = self.rb.position.cpu().numpy()
        target = np.array([p[0], p[1], altitude], np.float32)
        N = self.smoother_state.positions.shape[-2]
        ts = self.sim_time + 0.2 * np.arange(N)
        alpha = np.linspace(0, 1, N)[:, None]

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

        traj = Trajectory(
            timestamps=t(ts),
            positions=t((1 - alpha) * p + alpha * target),
            velocities=t(np.zeros((N, 3))),
            accelerations=t(np.zeros((N, 3))),
        )
        return await self.send_trajectory(traj)

    async def land(self) -> bool:
        return await self.takeoff(0.0) if self.armed else False

    async def emergency_stop(self) -> None:
        """Cut motors (reference emergency behavior)."""
        self.armed = False

    # -- simulation stepping (software-only extension) --
    def step(self, dt: Optional[float] = None) -> DroneState:
        """Advance one control tick: smoother -> controller -> physics."""
        dt = dt or self.control_dt
        ds = self.rb.to_drone_state(self.sim_time)
        (pos_d, vel_d, acc_d), self.smoother_state = get_desired_state(
            self.smoother_config, self.smoother_state, self.sim_time, ds
        )
        sp = geometric.ControlSetpoint(
            position=pos_d, velocity=vel_d, acceleration=acc_d,
            yaw=self._zero, yaw_rate=self._zero,
        )
        cmd, self.ctrl_state = geometric.compute_control(
            self.controller_config, self.ctrl_state, ds, sp, dt
        )
        if not self.armed:
            cmd = cmd.replace(thrust=torch.zeros_like(cmd.thrust))
        # expose the actuated wrench for external watchdogs (the mission
        # runner's motor-saturation monitor, hardware/mission.py)
        self.last_command = cmd
        self.rb = phys.rigid_body_step(self.physics, self.rb, cmd, dt)
        self.sim_time += dt
        return self.get_state()

    def run_for(self, duration: float) -> DroneState:
        steps = int(duration / self.control_dt)
        for _ in range(steps):
            self.step()
        return self.get_state()


VehicleIOFactory.register("simulated", SimulatedVehicleIO)
