"""L1 global mission planning (PyTorch counterpart of
:mod:`dart_planner_tpu.planning.global_mission`: numpy over the port's
``DroneState``, whose position is copied to the host once a call).

Port of the reference ``GlobalMissionPlanner``
(the reference's planning/global_mission_planner.py, "GMP"): mission phases (GMP:17-25), semantic waypoints (GMP:28-38),
phase-based goal selection (GMP:182-360), uncertainty-aware exploration
with spiral fallback (GMP:266-295), and neural-scene hooks — without the
pint unit objects (SI floats by convention, like the rest of this
framework).
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from dart_planner_tpu_torch.common.device import to_host
from dart_planner_tpu_torch.common.types import DroneState
from dart_planner_tpu_torch.neural_scene import UncertaintyField


class MissionPhase(enum.Enum):
    """(GMP:17-25)"""

    TAKEOFF = "takeoff"
    EXPLORATION = "exploration"
    MAPPING = "mapping"
    NAVIGATION = "navigation"
    LANDING = "landing"
    EMERGENCY = "emergency"


@dataclass
class SemanticWaypoint:
    """(GMP:28-38)"""

    position: np.ndarray  # m
    semantic_label: str = "waypoint"  # e.g. "safe_zone", "landing_pad"
    uncertainty: float = 0.0
    priority: int = 1

    def __post_init__(self):
        self.position = np.asarray(self.position, np.float32)


@dataclass
class GlobalMissionConfig:
    """(GMP:41-68)"""

    exploration_radius: float = 50.0  # m
    mapping_resolution: float = 0.5  # m
    safety_margin: float = 2.0  # m
    use_neural_scene: bool = False
    uncertainty_threshold: float = 0.7
    enable_multi_agent: bool = False
    communication_range: float = 100.0  # m
    global_replan_frequency: float = 1.0  # Hz
    waypoint_reached_threshold: float = 2.0  # m (GMP:330)
    takeoff_altitude: float = 5.0  # m (GMP:256)


class GlobalMissionPlanner:
    """(GMP:70-482)"""

    def __init__(
        self,
        config: Optional[GlobalMissionConfig] = None,
        uncertainty_field: Optional[UncertaintyField] = None,
    ):
        self.config = config or GlobalMissionConfig()
        self.current_phase = MissionPhase.TAKEOFF
        self.mission_waypoints: List[SemanticWaypoint] = []
        self.current_waypoint_index = 0
        self.explored_regions: List[np.ndarray] = []
        self.uncertainty_field = uncertainty_field
        self.planning_history: List[Dict[str, Any]] = []
        self.last_global_plan_time = 0.0

    # -- mission setup (GMP:171-180) --
    def set_mission_waypoints(self, waypoints: List[SemanticWaypoint]) -> None:
        self.mission_waypoints = list(waypoints)
        self.current_waypoint_index = 0

    def trigger_emergency(self) -> None:
        self.current_phase = MissionPhase.EMERGENCY

    # -- main interface (GMP:182-222) --
    def get_current_goal(self, state: DroneState) -> np.ndarray:
        now = time.time()
        if now - self.last_global_plan_time > 1.0 / self.config.global_replan_frequency:
            self._execute_global_planning(state)
            self.last_global_plan_time = now

        phase_planners = {
            MissionPhase.TAKEOFF: self._plan_takeoff_goal,
            MissionPhase.EXPLORATION: self._plan_exploration_goal,
            MissionPhase.MAPPING: self._plan_navigation_goal,  # (GMP:299)
            MissionPhase.NAVIGATION: self._plan_navigation_goal,
            MissionPhase.LANDING: self._plan_landing_goal,
            MissionPhase.EMERGENCY: self._plan_emergency_goal,
        }
        return phase_planners[self.current_phase](state)

    def _execute_global_planning(self, state: DroneState) -> None:
        """(GMP:224-252)"""
        pos = to_host(state.position, np.float32)
        if self.uncertainty_field is not None:
            # visiting reduces local uncertainty
            self.uncertainty_field.reduce_uncertainty_around_position(
                pos, radius=self.config.mapping_resolution * 6
            )
        self.planning_history.append(
            {
                "timestamp": time.time(),
                "phase": self.current_phase.value,
                "position": pos.copy(),
                "waypoint_index": self.current_waypoint_index,
            }
        )

    # -- phase planners --
    def _plan_takeoff_goal(self, state: DroneState) -> np.ndarray:
        """(GMP:254-265)"""
        pos = to_host(state.position, np.float32)
        goal = pos.copy()
        goal[2] = self.config.takeoff_altitude
        if pos[2] >= self.config.takeoff_altitude - 0.5:
            self.current_phase = (
                MissionPhase.NAVIGATION
                if self.mission_waypoints
                else MissionPhase.EXPLORATION
            )
        return goal

    def _plan_exploration_goal(self, state: DroneState) -> np.ndarray:
        """Uncertainty-directed or spiral exploration (GMP:266-295)."""
        pos = to_host(state.position, np.float32)
        if self.uncertainty_field is not None:
            targets = self.uncertainty_field.get_exploration_targets(
                pos, max_targets=1, threshold=self.config.uncertainty_threshold
            )
            if targets:
                return np.asarray(targets[0], np.float32)
        # spiral fallback
        angle = len(self.explored_regions) * 0.5
        radius = min(
            10.0 + len(self.explored_regions) * 2.0,
            self.config.exploration_radius,
        )
        goal = np.array(
            [
                pos[0] + radius * np.cos(angle),
                pos[1] + radius * np.sin(angle),
                pos[2],
            ],
            np.float32,
        )
        self.explored_regions.append(goal)
        return goal

    def _plan_navigation_goal(self, state: DroneState) -> np.ndarray:
        """(GMP:303-345)"""
        pos = to_host(state.position, np.float32)
        if not self.mission_waypoints:
            return pos
        if self.current_waypoint_index >= len(self.mission_waypoints):
            self.current_phase = MissionPhase.LANDING
            return pos
        wp = self.mission_waypoints[self.current_waypoint_index]
        if (
            np.linalg.norm(pos - wp.position)
            < self.config.waypoint_reached_threshold
        ):
            self.current_waypoint_index += 1
            if self.current_waypoint_index >= len(self.mission_waypoints):
                self.current_phase = MissionPhase.LANDING
                return pos
            wp = self.mission_waypoints[self.current_waypoint_index]
        return self._apply_semantic_reasoning(wp)

    def _apply_semantic_reasoning(self, wp: SemanticWaypoint) -> np.ndarray:
        """Semantic approach offsets (GMP waypoint-approach reasoning):
        stand off from obstacles; approach landing pads from above."""
        goal = wp.position.copy()
        if wp.semantic_label == "obstacle":
            goal[2] += self.config.safety_margin
        elif wp.semantic_label == "landing_pad":
            goal[2] += 1.0  # hover above before descending
        return goal

    def _plan_landing_goal(self, state: DroneState) -> np.ndarray:
        """Gradual descent (GMP:347-358)."""
        pos = to_host(state.position, np.float32)
        goal = pos.copy()
        goal[2] = max(0.5, pos[2] - 1.0)
        return goal

    def _plan_emergency_goal(self, state: DroneState) -> np.ndarray:
        """Fast descent (GMP:360-366)."""
        pos = to_host(state.position, np.float32)
        goal = pos.copy()
        goal[2] = max(0.0, pos[2] - 2.0)
        return goal

    def get_mission_status(self) -> Dict[str, Any]:
        """(GMP mission-status getter)"""
        return {
            "phase": self.current_phase.value,
            "waypoint_index": self.current_waypoint_index,
            "total_waypoints": len(self.mission_waypoints),
            "explored_regions": len(self.explored_regions),
            "planning_events": len(self.planning_history),
        }
