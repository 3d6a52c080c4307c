"""Three-layer cloud planning service (PyTorch counterpart of
:mod:`dart_planner_tpu.apps.cloud`).

Port of the reference ``cloud/main_improved_threelayer.py`` ("C3"):
``ThreeLayerCloudController`` wires L1 (global mission planner), L2
(SE(3) MPC), and perception (voxel mapper) behind a ZMQ REP service
(C3:58-124); the 10 Hz planning loop simulates lidar, refreshes mapper
obstacles into the planner, and serves trajectories to the edge
(C3:175-276, obstacle refresh C3:381-398).

The mapper, the planner (its plans through kernel B1 on the card, two
launches a plan at the default config) and the scene live on one device
(``device``, default: the card). The ZMQ handlers run on the server's
thread: they build the state on that device and reply with host copies.
``server`` takes an already-built request handler (any
:class:`~dart_planner_tpu_torch.comms.zmq_transport.RequestHandler`) in
place of the ``ZmqServer`` the controller builds by default.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from dart_planner_tpu_torch.common.device import resolve_device, to_host
from dart_planner_tpu_torch.common.logging_config import get_logger
from dart_planner_tpu_torch.common.types import DroneState
from dart_planner_tpu_torch.comms import SecureSerializer, ZmqServer
from dart_planner_tpu_torch.comms.zmq_transport import RequestHandler
from dart_planner_tpu_torch.perception import GeometricMapper
from dart_planner_tpu_torch.planning.global_mission import (
    GlobalMissionPlanner,
    SemanticWaypoint,
)
from dart_planner_tpu_torch.planning.se3_mpc import SE3MPCConfig, SE3MPCPlanner

logger = get_logger("apps.cloud")


class ThreeLayerCloudController:
    """(C3:58-398)"""

    def __init__(
        self,
        port: int = 5555,
        planning_frequency: float = 10.0,
        mpc_config: Optional[SE3MPCConfig] = None,
        serializer: Optional[SecureSerializer] = None,
        server: Optional[RequestHandler] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.planning_frequency = planning_frequency
        self.global_planner = GlobalMissionPlanner()
        self.se3_planner = SE3MPCPlanner(mpc_config or SE3MPCConfig(), device=self.device)
        self.mapper = GeometricMapper(resolution=0.5, max_range=60.0, device=self.device)
        self.scene_obstacles = torch.zeros((0, 4), dtype=torch.float32, device=self.device)
        self.last_trajectory = None
        self.last_state: Optional[DroneState] = None
        self.plan_count = 0
        self._running = False

        self.server = server if server is not None else ZmqServer(
            port=port, serializer=serializer
        )
        self.server.add_handler("get_trajectory", self._handle_get_trajectory)
        self.server.add_handler("update_state", self._handle_update_state)
        self.server.add_handler("set_waypoints", self._handle_set_waypoints)
        self.server.add_handler("status", self._handle_status)

    # -- demo scenario (C3:126-173) --
    def initialize_demo_mission(self) -> None:
        self.global_planner.set_mission_waypoints(
            [
                SemanticWaypoint(np.array([10.0, 0.0, 5.0]), "safe_zone", 0.1, 1),
                SemanticWaypoint(np.array([20.0, 10.0, 6.0]), "exploration_target", 0.4, 2),
                SemanticWaypoint(np.array([5.0, 15.0, 4.0]), "landing_pad", 0.1, 3),
            ]
        )
        for center, r in (
            ((12.0, 3.0, 4.0), 1.5),
            ((16.0, 7.0, 5.0), 2.0),
        ):
            self.mapper.add_obstacle(np.asarray(center, np.float32), r)
            obs = torch.tensor([[*center, r]], dtype=torch.float32, device=self.device)
            self.scene_obstacles = torch.cat([self.scene_obstacles, obs], dim=0)

    # -- ZMQ handlers (C3:105-124) --
    def _handle_get_trajectory(self, data: Any) -> Dict[str, Any]:
        t = self.last_trajectory
        if t is None:
            return {"available": False}
        # one host copy of the plan: (N, 10) rows of t, p, v, a
        rows = to_host(
            torch.cat(
                [t.timestamps[:, None], t.positions, t.velocities, t.accelerations], dim=-1
            ),
            np.float32,
        )
        return {
            "available": True,
            "timestamps": rows[:, 0],
            "positions": rows[:, 1:4],
            "velocities": rows[:, 4:7],
            "accelerations": rows[:, 7:10],
        }

    def _handle_update_state(self, data: Dict[str, Any]) -> Dict[str, Any]:
        # on the planner's device, not this thread's current one
        self.last_state = DroneState.create(
            timestamp=float(data.get("timestamp", time.time())),
            position=np.asarray(data["position"], np.float32),
            velocity=np.asarray(data.get("velocity", (0, 0, 0)), np.float32),
            device=self.se3_planner.device,
        )
        return {"ok": True}

    def _handle_set_waypoints(self, data: Dict[str, Any]) -> Dict[str, Any]:
        wps = [
            SemanticWaypoint(
                np.asarray(w["position"], np.float32),
                w.get("label", "waypoint"),
                w.get("uncertainty", 0.0),
                w.get("priority", 1),
            )
            for w in data["waypoints"]
        ]
        self.global_planner.set_mission_waypoints(wps)
        return {"ok": True, "count": len(wps)}

    def _handle_status(self, data: Any) -> Dict[str, Any]:
        return {
            "plans": self.plan_count,
            "mission": self.global_planner.get_mission_status(),
            "mapper": self.mapper.get_mapping_stats(),
            "planner": self.se3_planner.get_planning_stats(),
        }

    # -- planning loop (C3:175-276) --
    def _refresh_obstacles_from_mapper(self, state: DroneState) -> None:
        """mapper local grid -> thresh 0.6 -> nearest-K -> planner
        (C3:381-398)."""
        obs, mask = self.mapper.extract_obstacles(
            state.position,
            max_obstacles=self.se3_planner.config.max_obstacles,
        )
        self.se3_planner.clear_obstacles()
        for row, ok in zip(obs, mask):
            if ok:
                self.se3_planner.add_obstacle(row[:3], float(row[3]))

    def plan_once(self) -> None:
        """One 10 Hz tick: sense -> L1 goal -> refresh obstacles -> L2 plan
        (C3:229-276)."""
        if self.last_state is None:
            return
        state = self.last_state
        if self.scene_obstacles.shape[0]:
            o, d, t = self.mapper.simulate_lidar_scan(
                state.position, self.scene_obstacles
            )
            self.mapper.update_map(o, d, t)
        goal = self.global_planner.get_current_goal(state)
        self._refresh_obstacles_from_mapper(state)
        self.last_trajectory = self.se3_planner.plan_trajectory(state, goal)
        self.plan_count += 1

    async def run_planning_loop(self, duration: Optional[float] = None) -> None:
        """(C3:175-227)"""
        self.server.start()
        self._running = True
        period = 1.0 / self.planning_frequency
        t_end = time.time() + duration if duration else None
        try:
            while self._running and (t_end is None or time.time() < t_end):
                t0 = time.time()
                self.plan_once()
                await asyncio.sleep(max(0.0, period - (time.time() - t0)))
        finally:
            self.server.stop()
            self._running = False

    def stop(self) -> None:
        self._running = False


async def main(port: int = 5555, duration: Optional[float] = None, device=None) -> None:
    """(C3:401-426)"""
    controller = ThreeLayerCloudController(port=port, device=device)
    controller.initialize_demo_mission()
    logger.info("three-layer cloud controller on port %d", port)
    await controller.run_planning_loop(duration)
