"""The plain references agree with the port's plain paths (``method="torch"``
and the plain tick block) at small sizes on the CPU, and what the
benchmark's files may import."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest
import torch

from benchmark.lib import harness
from benchmark.reference import loop as ref_loop
from benchmark.reference import solve as ref


def _problem(B: int, gen: torch.Generator):
    from dart_planner_tpu_torch.planning import se3_mpc

    def randn(*shape):
        return torch.randn(shape, generator=gen)

    obs = torch.cat([randn(B, 4, 3) * 3, torch.rand((B, 4, 1), generator=gen) + 0.3], -1)
    return se3_mpc.make_problem(randn(B, 3) + torch.tensor([0, 0, 5.0]), randn(B, 3),
                                randn(B, 3) * 4 + torch.tensor([0, 0, 5.0]), obstacles=obs,
                                config=se3_mpc.SE3MPCConfig(), device="cpu")


@pytest.mark.parametrize("cfg", [{}, {"tail_iterations": 0, "goal_margin_clamp": 0.5},
                                  {"prediction_horizon": 12, "cg_iterations": 4}])
def test_solve_is_the_ports_plain_solve(cfg):
    from dart_planner_tpu_torch.planning import se3_mpc

    config = se3_mpc.SE3MPCConfig(**cfg)
    gen = torch.Generator().manual_seed(3)
    prob = _problem(24, gen)
    want = se3_mpc.solve(config, prob, method="torch")
    got = ref.solve(ref.SolverConfig.from_dict(config._asdict()), ref.Problem(*prob))
    for name in ("thrusts", "positions", "velocities", "accelerations", "cost", "converged"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name), rtol=1e-6,
                                   atol=1e-6, msg=name)
    warm = se3_mpc.shift_warm_start(config, want.thrusts)
    torch.testing.assert_close(ref.shift(want.thrusts), warm, rtol=0, atol=0)


def test_problem_margins_are_the_ports():
    from dart_planner_tpu_torch.planning import se3_mpc

    gen = torch.Generator().manual_seed(4)
    spheres = torch.cat([torch.randn((8, 3, 3), generator=gen),
                         torch.rand((8, 3, 1), generator=gen)], -1)
    p, v, g = (torch.randn((8, 3), generator=gen) for _ in range(3))
    for clamp in (0.0, 0.5):
        config = se3_mpc.SE3MPCConfig(goal_margin_clamp=clamp)
        want = se3_mpc.make_problem(p, v, g, obstacles=spheres, config=config)
        got = ref.make_problem(ref.SolverConfig.from_dict(config._asdict()), p, v, g, spheres)
        for name in ("p0", "v0", "goal", "obstacles", "obstacle_mask"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_extract_is_the_ports_extract_trajectory():
    from dart_planner_tpu_torch.planning import se3_mpc

    config = se3_mpc.SE3MPCConfig()
    res = se3_mpc.solve(config, _problem(16, torch.Generator().manual_seed(5)), method="torch")
    stamps = torch.linspace(0.0, 1.5, 16)
    want = se3_mpc.extract_trajectory(config, res, stamps)
    att, rates, tmag, ts = ref.extract(ref.SolverConfig(), res.thrusts, stamps)
    for got, name in ((att, "attitudes"), (rates, "body_rates"), (tmag, "thrusts"),
                      (ts, "timestamps")):
        torch.testing.assert_close(got, getattr(want, name), rtol=1e-5, atol=1e-5, msg=name)


@pytest.mark.parametrize("arm", [{}, {"anti_windup_method": "back_calculation"},
                                 {"yaw_convention": "reference"},
                                 {"anti_windup_method": "back_calculation",
                                  "yaw_convention": "reference"}])
def test_tick_block_is_the_ports_plain_tick_block(arm):
    from dart_planner_tpu_torch.control.geometric import ControllerState, GeometricConfig
    from dart_planner_tpu_torch.ops import cuda_rollout
    from dart_planner_tpu_torch.sim.physics import PhysicsConfig, RigidBodyState

    gen = torch.Generator().manual_seed(6)
    B, T, K = 24, 40, 3
    ctrl_cfg = GeometricConfig(mass=1.5, max_thrust=25.0, **arm)
    plant = PhysicsConfig(max_thrust=25.0)
    back = cuda_rollout.back_calculation(ctrl_cfg)
    angles = 0.3 * torch.randn((B, 3), generator=gen)
    from dart_planner_tpu_torch.ops import so3

    rb = RigidBodyState(position=torch.randn((B, 3), generator=gen) + torch.tensor([0, 0, 3.0]),
                        velocity=torch.randn((B, 3), generator=gen),
                        rotation=so3.euler_to_rotmat(angles),
                        angular_velocity=0.5 * torch.randn((B, 3), generator=gen))
    ctrl = ControllerState.zeros(ctrl_cfg, (B,), device="cpu")
    S = cuda_rollout.pack_state(rb, ctrl, back)
    plan = [torch.randn((B, 20, 3), generator=gen) for _ in range(3)]
    plan[0] = plan[0] + rb.position[:, None, :]
    sp = cuda_rollout.setpoints_from_plan(*plan, T, 0.0025, 0.1)
    for mine, theirs in zip(ref_loop.setpoints(T, 0.0025, 0.1, *plan), sp):
        torch.testing.assert_close(mine, theirs, rtol=0, atol=1e-6)
    wind = torch.randn((B, 3), generator=gen)
    gw = torch.cat([torch.randn((3, B), generator=gen), wind.T, torch.zeros(2, B)]).contiguous()
    spheres = torch.cat([torch.randn((B, K, 3), generator=gen) * 2 + rb.position[:, None, :],
                         torch.rand((B, K, 1), generator=gen)], -1)
    obs = cuda_rollout.pack_obstacles(spheres, torch.ones((B, K), dtype=torch.bool))
    want = cuda_rollout.run_tick_block_plain(ctrl_cfg, plant, 0.0025, T, 1, S, *sp, gw, obs)
    got = ref_loop.tick_block(ctrl_cfg._asdict(), plant._asdict(), 0.0025, T, 1, S, *sp, gw,
                              obs)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)


def test_initial_rows_are_the_ports_packed_rest_state():
    from dart_planner_tpu_torch.common.types import DroneState
    from dart_planner_tpu_torch.control.geometric import ControllerState, GeometricConfig
    from dart_planner_tpu_torch.ops import cuda_rollout
    from dart_planner_tpu_torch.sim.physics import RigidBodyState

    ctrl_cfg = GeometricConfig(mass=1.5, max_thrust=25.0)
    starts = torch.randn(5, 3)
    st = DroneState.zeros((5,), device="cpu").replace(position=starts)
    S = cuda_rollout.pack_state(RigidBodyState.from_drone_state(st),
                                ControllerState.zeros(ctrl_cfg, (5,), device="cpu"))
    assert torch.equal(ref_loop.initial_rows(starts, ctrl_cfg._asdict()), S)


def _imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_what_the_benchmark_imports():
    """The reference imports no part of the program, JAX or the JAX package;
    no file the runs load imports JAX, the JAX package, ``bench_torch.py``,
    ``chip_smoke.py`` or ``scripts/``."""
    for path in (harness.HERE / "reference").glob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert tops <= {"__future__", "math", "typing", "numpy", "torch", "benchmark"}, path
    for path in harness.HERE.rglob("*.py"):
        if "tests" in path.parts:
            continue
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "dart_planner_tpu", "bench_torch",
                               "chip_smoke", "scripts") and not top.startswith("diag_"), path
    probe = ("import json, sys; sys.path.insert(0, sys.argv[1]);"
             "import benchmark.reference.checks, benchmark.reference.loop;"
             "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe, str(harness.ROOT)], capture_output=True,
                         text=True, timeout=120)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "dart_planner_tpu", "dart_planner_tpu_torch"}
