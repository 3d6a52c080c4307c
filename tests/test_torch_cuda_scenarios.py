"""The slice's paths on the card: the scenario fleet, figure-8 tracking and
the resumable sweep through kernels B1 and B2 (dart_planner_tpu_torch/
parallel/, sim/scenarios.py, sim/checkpoint.py).

On the CPU: the sweep runs on the card unless asked for the CPU, and the
kernel wrappers' CPU arms (their plain versions) give figure-8 the same
flight as the per-tick path without counting a launch (1e-4 m).
On a CUDA device (tests marked ``cuda``): hover-to-waypoint and mapper
navigation with one launch of B1 each (mapper navigation's cost within
1e-3 relative of the CPU's and its end point within 5e-2 m: at the full
budget the kernel and the plain loop part at equal cost, ROADMAP C.9);
figure-8 at the default solver
through B1 and B2 against the plain path on the card over 20 replans
(positions 1e-3 m, RMSE 1% relative, one launch of each kernel a replan);
B2 at figure-8's shape (B=1, T=8, K=0) against ``run_tick_block_plain``
(atol 1e-4 + rtol 1e-4, as every B2 test); and the fleet at 131,071
scenarios, a batch that fills no kernel block evenly, with its stats
all-reduced through an NCCL group of one process (equal to the host's
float64 summary to 1e-6 relative; two launches of B1), held against the
plain version there: one Newton round in every scenario at phase 1's and
the tail's configs (2e-3, cost 1e-4 relative, on all but 1e-4 of them and
every one within 5x that), and the whole fleet's
converged fraction (0.002) and mean cost (1e-3). Nothing here imports
JAX, so the CUDA tests run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_scenarios.py -m cuda
"""

import socket

import numpy as np
import pytest
import torch

from dart_planner_tpu_torch import DroneState
from dart_planner_tpu_torch.control import geometric
from dart_planner_tpu_torch.ops import costs, cuda_mpc, cuda_rollout
from dart_planner_tpu_torch.parallel import distributed, scenario
from dart_planner_tpu_torch.planning import se3_mpc
from dart_planner_tpu_torch.sim import ClosedLoopConfig, checkpoint, physics, scenarios

FAST = se3_mpc.SE3MPCConfig(prediction_horizon=10, max_iterations=6)


def test_sweep_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        checkpoint.run_sweep(ClosedLoopConfig(), 4, 2, (0.0, 0.0, 3.0), (3.0, 0.0, 4.0),
                             tmp_path / "s.npz")
    assert not (tmp_path / "s.npz").exists()


def test_figure8_wrappers_on_cpu_fly_as_the_tick_loop_and_launch_nothing():
    before = (cuda_mpc.LAUNCHES, cuda_rollout.LAUNCHES)
    fused = scenarios.figure8_tracking(FAST, num_replans=12, device="cpu", method="fused")
    assert (cuda_mpc.LAUNCHES, cuda_rollout.LAUNCHES) == before
    plain = scenarios.figure8_tracking(FAST, num_replans=12, device="cpu", method="torch")
    torch.testing.assert_close(fused.positions, plain.positions, atol=1e-4, rtol=0)
    assert scenarios.figure8_tracking(FAST, num_replans=3, device="cpu").positions.shape == (3, 3)


def test_figure8_out_of_tick_block_scope_runs_the_tick_loop_on_cpu():
    """On CPU tensors a config outside B2's scope flies the per-tick loop,
    as the closed loop does; on the card it raises (closed_loop's rule)."""
    ctl = geometric.GeometricConfig(mass=1.5, max_thrust=25.0, yaw_convention="reference")
    a = scenarios.figure8_tracking(FAST, control=ctl, num_replans=4, device="cpu",
                                   method="fused")
    b = scenarios.figure8_tracking(FAST, control=ctl, num_replans=4, device="cpu",
                                   method="torch")
    assert torch.equal(a.positions, b.positions)


# ---- CUDA ---------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_figure8_through_both_kernels_matches_the_plain_path(cuda_device):
    R = 20
    before = (cuda_mpc.LAUNCHES, cuda_rollout.LAUNCHES)
    fused = scenarios.figure8_tracking(num_replans=R, device=cuda_device, method="fused")
    torch.cuda.synchronize()
    assert (cuda_mpc.LAUNCHES - before[0], cuda_rollout.LAUNCHES - before[1]) == (R, R)
    plain = scenarios.figure8_tracking(num_replans=R, device=cuda_device, method="torch")
    assert fused.positions.device.type == "cuda"
    torch.testing.assert_close(fused.positions, plain.positions, atol=1e-3, rtol=0)
    torch.testing.assert_close(fused.tracking_rmse, plain.tracking_rmse, atol=0, rtol=1e-2)
    with pytest.raises(ValueError, match="method='torch'"):
        scenarios.figure8_tracking(
            control=geometric.GeometricConfig(mass=1.5, max_thrust=25.0,
                                              anti_windup_method="back_calculation"),
            num_replans=2, device=cuda_device, method="fused")


@pytest.mark.cuda
def test_cuda_hover_and_mapper_navigation_launch_b1_once(cuda_device):
    """BASELINE configs 1-2 on the card: one launch of B1 each; the mapper
    facade takes its own CUDA tensors (the lidar scan's default mask)."""
    for run in (scenarios.hover_to_waypoint, lambda: scenarios.mapper_navigation()[0]):
        before = cuda_mpc.LAUNCHES
        res = run()
        torch.cuda.synchronize()
        assert cuda_mpc.LAUNCHES == before + 1
        assert res.positions.device.type == "cuda" and torch.isfinite(res.positions).all()
    res, mapper = scenarios.mapper_navigation(device=cuda_device)
    assert mapper.is_trajectory_safe(res.positions.cpu().numpy(), 0.2, 0.8)
    cpu_res, _ = scenarios.mapper_navigation(device="cpu")
    torch.testing.assert_close(res.cost.cpu(), cpu_res.cost, atol=0, rtol=1e-3)
    torch.testing.assert_close(res.positions[-1].cpu(), cpu_res.positions[-1], atol=5e-2,
                               rtol=0)


@pytest.mark.cuda
def test_cuda_tick_block_at_figure8_shape(cuda_device):
    """B2 at B=1, T=8, K=0 (no obstacle rows) on a real figure-8 plan."""
    mpc = se3_mpc.SE3MPCConfig()
    ctl = geometric.GeometricConfig(mass=1.5, max_thrust=25.0)
    phys_cfg = physics.PhysicsConfig(max_thrust=25.0)
    p0 = torch.tensor([[0.0, 0.5, 3.0]], device=cuda_device)
    v0 = torch.tensor([[2.0, 1.9, 0.0]], device=cuda_device)
    goal = torch.tensor([[0.8, 0.9, 3.1]], device=cuda_device)
    res = se3_mpc.solve(mpc, se3_mpc.make_problem(p0, v0, goal, config=mpc), method="cuda")
    rb = physics.RigidBodyState.from_drone_state(
        DroneState.zeros((1,), device=cuda_device).replace(position=p0, velocity=v0))
    S = cuda_rollout.pack_state(rb, geometric.ControllerState.zeros(ctl, (1,), device=cuda_device))
    sp = cuda_rollout.setpoints_from_plan(res.positions, res.velocities, res.accelerations,
                                          8, 0.0025, mpc.dt)
    gw = torch.zeros((8, 1), device=cuda_device)
    args = (ctl, phys_cfg, 0.0025, 8, 1, S, *sp, gw, None)
    before = cuda_rollout.LAUNCHES
    ks, ka = cuda_rollout.run_tick_block(*args)
    torch.cuda.synchronize()
    assert cuda_rollout.LAUNCHES == before + 1
    ps, pa = cuda_rollout.run_tick_block_plain(*args)
    assert ks.shape == (32, 1) and bool(ka[3, 0] == 1e30)
    torch.testing.assert_close(ks, ps, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(ka, pa, atol=1e-4, rtol=1e-4)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.cuda
def test_cuda_fleet_at_an_odd_batch_with_an_nccl_world_of_one(cuda_device):
    B = 131_071
    rng = np.random.default_rng(0)
    obs = np.concatenate([rng.normal(0, 4, (B, 4, 3)), rng.uniform(0.3, 1.2, (B, 4, 1))],
                         axis=-1).astype(np.float32)
    config = se3_mpc.SE3MPCConfig()
    prob = se3_mpc.make_problem(
        rng.normal(0, 2, (B, 3)).astype(np.float32) + np.float32([0, 0, 5]),
        rng.normal(0, 1, (B, 3)).astype(np.float32),
        rng.normal(0, 5, (B, 3)).astype(np.float32) + np.float32([0, 0, 5]),
        obstacles=obs, config=config, device=cuda_device,
    )
    distributed.initialize(f"localhost:{_free_port()}", 1, 0, backend="nccl")
    try:
        mesh = scenario.make_fleet_mesh()
        before = cuda_mpc.LAUNCHES
        res, st = scenario.solve_fleet(config, mesh, prob)
        torch.cuda.synchronize()
        launches = cuda_mpc.LAUNCHES - before
        assert st.total.device.type == "cuda"
    finally:
        distributed.shutdown()
    assert launches == 2
    host = scenario.fleet_statistics(res)
    assert int(st.total) == host["total"] == B
    assert int(st.converged) == host["converged"]
    np.testing.assert_allclose(float(st.mean_cost), host["mean_cost"], rtol=1e-6)
    assert float(st.max_grad_norm) == host["max_grad_norm"]
    assert torch.isfinite(res.shards[0].cost).all()
    assert host["converged"] / B >= 0.957

    # the kernel against its plain version at this batch: one Newton round
    # at CG-2, where float32 rounding cannot branch the path, at phase 1's
    # config and at the tail's on the first 32,768. Thrusts, positions and
    # velocities to 2e-3 and the cost to 1e-4 relative on all but 1e-4 of
    # the elements (scenarios), every one within 5x that: the rounding's
    # tail grows with the batch, a misplaced launch parts whole blocks
    cfg_t = config._replace(
        max_iterations=config.tail_iterations, cg_iterations=config.tail_cg_iterations,
        newton_full_curvature=True, gn_warmup_iterations=0, tail_iterations=0,
        line_search_alphas=config.tail_line_search_alphas,
    )
    C = -(-B // 4)
    for cfg, pr in ((config._replace(tail_iterations=0), prob),
                    (cfg_t, costs.Problem(*[x if x is None else x[:C] for x in prob]))):
        cfg = cfg._replace(max_iterations=1, cg_iterations=2)
        u0 = se3_mpc.initialize_thrusts(config, pr)
        k = cuda_mpc.solve_thrusts_fused(cfg, pr, u0)
        p = cuda_mpc.solve_thrusts_plain(cfg, pr, u0)
        for d, lim in [((k[i] - p[i]).abs(), 2e-3) for i in (0, 2, 3)] + [
                ((k[4] - p[4]).abs() / p[4].abs(), 1e-4)]:
            assert float((d > lim).float().mean()) <= 1e-4
            assert float(d.max()) <= 5 * lim
    # and the whole fleet through the plain path: at the full budget
    # near-ties part the two paths per scenario (ROADMAP C.9), so the
    # aggregates are held: converged fraction to 0.002, mean cost to 1e-3
    plain = scenario.fleet_statistics(scenario.solve_fleet(
        config, scenario.make_fleet_mesh(), prob, method="torch", with_stats=False)[0])
    assert abs(plain["converged"] - host["converged"]) <= 0.002 * B
    np.testing.assert_allclose(host["mean_cost"], plain["mean_cost"], rtol=1e-3)
