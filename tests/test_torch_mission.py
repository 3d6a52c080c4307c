"""The port's L1 mission layer (dart_planner_tpu_torch/planning/
global_mission.py, neural_scene/) against the JAX package on the same
inputs: the six cases of tests/test_mission.py, each driven through both
packages with the same states.

Goals and region centres are compared at atol 1e-6 (float32 numpy on the
same values), phases and counts exactly, the grids at atol 1e-6, and the
rendered view at atol 1e-6 both when it upsamples and when it downsamples
(``jax.image.resize``'s "linear" antialiases when it shrinks; the port's
bilinear interpolation does too).
"""

import numpy as np
import pytest
import torch

from dart_planner_tpu.common.types import DroneState as JDroneState
from dart_planner_tpu.neural_scene import PlaceholderNeuralScene as JScene
from dart_planner_tpu.neural_scene import UncertaintyField as JField
from dart_planner_tpu.planning import global_mission as J
from dart_planner_tpu_torch import DroneState, interop
from dart_planner_tpu_torch.neural_scene import PlaceholderNeuralScene, UncertaintyField
from dart_planner_tpu_torch.planning import global_mission as T

ATOL = 1e-6


class _Pair:
    """One GlobalMissionPlanner in each package, fed the same states."""

    def __init__(self, jcfg=None, jfield=None, tfield=None):
        self.j = J.GlobalMissionPlanner(jcfg, uncertainty_field=jfield)
        tcfg = None if jcfg is None else interop.global_mission_config_from_jax_fields(jcfg)
        self.t = T.GlobalMissionPlanner(tcfg, uncertainty_field=tfield)

    def goal(self, pos):
        jg = self.j.get_current_goal(JDroneState.create(position=pos))
        tg = self.t.get_current_goal(DroneState.create(position=pos, device="cpu"))
        np.testing.assert_allclose(tg, jg, atol=ATOL)
        assert self.t.current_phase.value == self.j.current_phase.value
        # "planning_events" counts the 1 Hz global replans by the wall clock,
        # which may tick between the two packages' calls
        js, ts = self.j.get_mission_status(), self.t.get_mission_status()
        js.pop("planning_events"), ts.pop("planning_events")
        assert ts == js
        return tg

    def set_waypoints(self, wps):
        self.j.set_mission_waypoints([J.SemanticWaypoint(np.array(p), lab) for p, lab in wps])
        self.t.set_mission_waypoints([T.SemanticWaypoint(np.array(p), lab) for p, lab in wps])

    def phase(self, name):
        self.j.current_phase = J.MissionPhase[name]
        self.t.current_phase = T.MissionPhase[name]


def test_takeoff_then_navigation_then_landing():
    pair = _Pair()
    pair.set_waypoints([([10.0, 0.0, 5.0], "safe_zone"), ([20.0, 5.0, 5.0], "landing_pad")])
    goal = pair.goal((0.0, 0.0, 0.0))
    assert pair.t.current_phase is T.MissionPhase.TAKEOFF
    assert goal[2] == 5.0
    pair.goal((0.0, 0.0, 4.8))
    assert pair.t.current_phase is T.MissionPhase.NAVIGATION
    np.testing.assert_allclose(pair.goal((0.0, 0.0, 5.0)), [10, 0, 5], atol=1e-6)
    np.testing.assert_allclose(pair.goal((9.5, 0.0, 5.0)), [20, 5, 6], atol=1e-6)
    pair.goal((20.0, 5.0, 5.5))
    assert pair.t.current_phase is T.MissionPhase.LANDING
    assert pair.goal((20.0, 5.0, 5.0))[2] == 4.0  # descend 1 m


def test_emergency_descent():
    pair = _Pair()
    pair.j.trigger_emergency()
    pair.t.trigger_emergency()
    goal = pair.goal((3.0, 3.0, 10.0))
    assert pair.t.current_phase is T.MissionPhase.EMERGENCY
    assert goal[2] == 8.0  # fast descent


def test_exploration_uses_uncertainty_field():
    bounds = np.array([[-20, -20, 0], [20, 20, 10]])
    jf = JField(bounds, resolution=2.0)
    tf = UncertaintyField(bounds, resolution=2.0, device="cpu")
    pair = _Pair(J.GlobalMissionConfig(use_neural_scene=True), jf, tf)
    pair.phase("EXPLORATION")
    goal = pair.goal((-15.0, -15.0, 5.0))
    assert np.linalg.norm(goal - np.asarray([-15, -15, 5])) > 3.0
    np.testing.assert_allclose(tf.grid.numpy(), np.asarray(jf.grid), atol=ATOL)
    assert tf.get_statistics() == pytest.approx(jf.get_statistics(), abs=ATOL)
    assert tf.get_statistics()["mean_uncertainty"] < 1.0  # visit registered


def test_exploration_spiral_fallback():
    pair = _Pair()
    pair.phase("EXPLORATION")
    g1 = pair.goal((0.0, 0.0, 5.0))
    g2 = pair.goal((0.0, 0.0, 5.0))
    assert not np.allclose(g1, g2)  # spiral advances
    assert pair.t.get_mission_status()["explored_regions"] == 2


def test_uncertainty_field_regions_and_targets():
    bounds = np.array([[0, 0, 0], [10, 10, 4]])
    jf = JField(bounds, resolution=1.0)
    jf.reduce_uncertainty_around_position([2.0, 2.0, 2.0], radius=3.0, factor=0.1)
    jf.update_uncertainty_at_position([9.2, 0.5, 3.5], 0.2)
    # the port starts from the JAX field's grid carried across, then both
    # apply the same updates
    tf = interop.uncertainty_field_from_jax(jf)
    for f in (jf, tf):
        f.reduce_uncertainty_around_position([8.0, 8.0, 1.0], radius=1.5, factor=0.5)
        f.update_uncertainty_at_position([0.5, 9.5, 0.5], 0.9)
    np.testing.assert_allclose(tf.grid.numpy(), np.asarray(jf.grid), atol=ATOL)
    assert tf.get_uncertainty_at_position([0.5, 9.5, 0.5]) == pytest.approx(0.9)
    jr = jf.identify_high_uncertainty_regions(threshold=0.7)
    tr = tf.identify_high_uncertainty_regions(threshold=0.7)
    assert tr, "unvisited space should form high-uncertainty regions"
    assert [r.size_voxels for r in tr] == [r.size_voxels for r in jr]
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(a.center, b.center, atol=ATOL)
        assert a.mean_uncertainty == pytest.approx(b.mean_uncertainty, abs=ATOL)
    targets = tf.get_exploration_targets([2.0, 2.0, 2.0], max_targets=3)
    jt = jf.get_exploration_targets([2.0, 2.0, 2.0], max_targets=3)
    assert 1 <= len(targets) <= 3 and len(targets) == len(jt)
    np.testing.assert_allclose(np.stack(targets), np.stack(jt), atol=ATOL)
    assert all(np.linalg.norm(t - [2, 2, 2]) > 2.0 for t in targets)


@pytest.mark.parametrize("resolution", [(32, 32), (7, 5)], ids=["upscale", "downscale"])
def test_placeholder_neural_scene_queries(resolution):
    bounds = np.array([[0, 0, 0], [10, 10, 5]])
    js = JScene(resolution=0.5)
    js.initialize_scene(bounds)
    ts = PlaceholderNeuralScene(resolution=0.5, device="cpu")
    ts.initialize_scene(bounds)
    # in-bounds points (two in one voxel) and one out of bounds
    pts = np.array([[1.0, 1.0, 1.0], [2.0, 2.0, 2.0], [2.1, 2.2, 2.3], [3.0, 7.5, 4.0],
                    [-1.0, 3.0, 3.0]])
    dens = np.array([0.9, 0.8, 0.6, 0.3, 0.7])
    for s in (js, ts):
        s.update_incremental((pts, dens))
        s.update_incremental((pts[2:], dens[2:] + 0.05))
    for name in ("density", "uncertainty", "semantics"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   atol=ATOL, err_msg=name)
    d = ts.query_density(pts[:2]).numpy()
    np.testing.assert_allclose(d, [0.9, 0.8], atol=1e-6)
    u = ts.query_uncertainty(pts).numpy()
    np.testing.assert_allclose(u, np.asarray(js.query_uncertainty(pts)), atol=ATOL)
    assert (u[:4] < 1.0).all() and u[4] == 1.0  # observed voxels lose uncertainty
    out = ts.query_density(np.array([[100.0, 0.0, 0.0]])).numpy()
    assert out[0] == 0.0  # out of bounds -> empty
    assert ts.query_semantic_label(pts).dtype == torch.int32
    img = ts.render_view(None, resolution)
    assert img.shape == resolution
    np.testing.assert_allclose(img.numpy(), np.asarray(js.render_view(None, resolution)),
                               atol=ATOL)
    assert ts.get_scene_statistics() == pytest.approx(js.get_scene_statistics(), abs=ATOL)
    # the JAX scene carried across gives the same queries
    carried = interop.placeholder_scene_from_jax(js)
    np.testing.assert_array_equal(carried.query_density(pts).numpy(),
                                  ts.query_density(pts).numpy())
