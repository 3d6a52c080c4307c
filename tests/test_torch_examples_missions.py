"""The port's mission examples (examples_torch/advanced/hardware_mission.py
and examples_torch/beginner/minimal_takeoff.py) on the CPU.

- hardware_mission flies its three waypoints at the JAX example's 100 Hz
  control, 10 Hz planning and 0.8 m tolerance, on the wall clock, so it
  keeps the JAX mission tests' one retry; its planner is
  ``SE3MPCConfig(max_iterations=4, gn_warmup_iterations=2,
  tail_iterations=0)``, about 21 ms a plan on a CPU against about 130 ms at
  the default config, which at 10 Hz would starve the asyncio loop (as in
  tests/test_torch_hardware_mission.py). All three waypoints are reached,
  no failsafe is set, and the report is complete: where the JAX runner,
  given the same final arrival seen twice, counts 4 of 3 waypoints and
  reports the mission incomplete (ROADMAP C, reference fault 17).
- minimal_takeoff: its altitudes inside the JAX package's band
  (tests/test_apps.py: a peak above 2 m, landed below 1.5 m), its printed
  line the one the JAX example prints for the same altitudes, and equal to
  the line the JAX example printed when run on the CPU (102 s there, too
  long for this suite; its flight is 13 s of eager ticks).
"""

import contextlib
import importlib.util
import io
import pathlib

import numpy as np

from dart_planner_tpu.common.types import DroneState as JDroneState
from dart_planner_tpu.hardware import mission as J_mission
from dart_planner_tpu.hardware.simulated_vehicle import SimulatedVehicleIO as JSim
from dart_planner_tpu_torch import DroneState
from dart_planner_tpu_torch.hardware.mission import MissionConfig, MissionRunner
from dart_planner_tpu_torch.hardware.simulated_vehicle import SimulatedVehicleIO
from dart_planner_tpu_torch.planning.se3_mpc import SE3MPCConfig, SE3MPCPlanner

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = SE3MPCConfig(max_iterations=4, gn_warmup_iterations=2, tail_iterations=0)
# examples/beginner/minimal_takeoff.py's line, run with JAX_PLATFORMS=cpu
JAX_TAKEOFF_LINE = "peak 2.74 m | hover 2.77 m | landed -0.00 m (target 3.0 m)"


def _load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _printed(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue().splitlines()


def _example(rel: str):
    return _load(ROOT / "examples_torch" / f"{rel}.py", "examples_torch_" + rel.replace("/", "_"))


def _retry_once(run):
    """Wall-clock coupled: retried once, as the JAX package's tests are."""
    last = None
    for _ in range(2):
        try:
            return run()
        except AssertionError as e:
            last = e
    raise last


def test_hardware_mission_reaches_every_waypoint():
    example = _example("advanced/hardware_mission")

    def run():
        out, lines = _printed(example.main, planner_config=SMALL, device="cpu")
        assert out["mission_complete"], out
        assert out["waypoints_reached"] == out["waypoints_total"] == 3
        assert out["failsafe_reason"] is None and out["planning_failures"] == 0
        return out, lines

    out, lines = _retry_once(run)
    assert out["control_hz"] == out["commands_sent"] / out["wall_s"] > 0
    assert out["card"] == "cpu, host clock"
    # the JAX example's lines, and the control rate reached
    assert lines[0] == "flying 3 waypoints ..."
    assert lines[1:3] == ["mission complete: True", "waypoints reached: 3/3"]
    assert lines[3].startswith("avg planning time: ") and lines[3].endswith(
        " ms (cpu, host clock)")
    assert lines[4] == f"commands sent: {out['commands_sent']}"
    assert lines[5].startswith("control rate reached: ") and " Hz of 100 over " in lines[5]
    assert lines[6].startswith("final position: [") and len(lines) == 7


def test_final_waypoint_counted_once_unlike_jax():
    """The example's last arrival seen by both the control and the planning
    tick: the port counts it once and reports the mission complete; the JAX
    runner counts it again (4 of 3) and reports it incomplete."""
    example = _example("advanced/hardware_mission")
    waypoints = [np.asarray(w, np.float32) for w in example.WAYPOINTS]
    config = dict(control_frequency=example.CONTROL_HZ, planning_frequency=example.PLANNING_HZ,
                  waypoint_tolerance=0.8)
    port = MissionRunner(SimulatedVehicleIO({"initial_position": (0.0, 0.0, 2.0)},
                                            device="cpu"),
                         MissionConfig(**config), planner=SE3MPCPlanner(SMALL, device="cpu"))
    jax_runner = J_mission.MissionRunner(JSim({"initial_position": (0.0, 0.0, 2.0)}),
                                         J_mission.MissionConfig(**config))
    at_goal = DroneState.create(position=example.WAYPOINTS[-1], device="cpu")
    j_at_goal = JDroneState.create(position=example.WAYPOINTS[-1])
    for runner, state in ((port, at_goal), (jax_runner, j_at_goal)):
        runner._waypoints = waypoints
        runner.state.waypoint_index = 2
        runner.state.waypoints_reached = 2
        runner._check_arrival(state)  # the control tick's check
        runner._check_arrival(state)  # the planning tick's, before the loops stop
    report = port.get_performance_report()
    assert (report["waypoints_reached"], report["waypoints_total"]) == (3, 3)
    assert report["mission_complete"]
    j_report = jax_runner.get_performance_report()
    assert (j_report["waypoints_reached"], j_report["waypoints_total"]) == (4, 3)
    assert not j_report["mission_complete"]


def test_minimal_takeoff_matches_the_jax_example(monkeypatch):
    out, lines = _printed(_example("beginner/minimal_takeoff").main, device="cpu")
    assert out["peak_altitude"] > 2.0 and out["final_altitude"] < 1.5
    assert out["target_altitude"] == 3.0
    assert lines == [JAX_TAKEOFF_LINE]

    jax_example = _load(ROOT / "examples" / "beginner" / "minimal_takeoff.py",
                        "jax_example_minimal_takeoff")

    async def same_flight(altitude, hover_s):
        assert (altitude, hover_s) == (3.0, 2.0)
        return out

    monkeypatch.setattr(jax_example, "minimal_takeoff", same_flight)
    _, jax_lines = _printed(jax_example.main)
    assert lines == jax_lines

