"""The kernels on a card other than the first, and the fleet over several
cards (ROADMAP C.17): every kernel wrapper launches with its tensors' card
current, and each NCCL process pins the card of its local rank.

On the CPU: how a process finds its local rank and which cards the worker
gives it. On two or more CUDA devices (tests marked ``cuda``; they skip
on a machine with fewer): kernel B1 on ``cuda:1`` against its plain version
there (one Newton round at CG-2, a path float32 rounding cannot branch:
thrusts 2e-3 N, as phase 3 of chip_smoke.py), kernel B2 on ``cuda:1``
against its plain version (atol 1e-4 + rtol 1e-4, as every B2 test);
``solve_fleet`` over ``cuda:0`` and ``cuda:1`` equal to one solve of the
same fleet on ``cuda:0`` (the kernel solves each scenario alone, so the
split cannot change a result: 1e-6), each shard on its own card with one
launch of B1; and two NCCL worker processes, one card each, whose
all-reduced stats equal a one-process recomputation. Nothing here imports
JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_multicard.py -m cuda
"""

import numpy as np
import pytest
import torch

from dart_planner_tpu_torch import DroneState
from dart_planner_tpu_torch.control import geometric
from dart_planner_tpu_torch.ops import cuda_mpc, cuda_rollout
from dart_planner_tpu_torch.parallel import distributed, scenario
from dart_planner_tpu_torch.planning import se3_mpc
from dart_planner_tpu_torch.sim import physics

FAST = se3_mpc.SE3MPCConfig(prediction_horizon=10, max_iterations=6, tail_iterations=0)
ONE_ROUND = se3_mpc.SE3MPCConfig(max_iterations=1, cg_iterations=2, tail_iterations=0)


def test_local_rank_prefers_the_launcher(monkeypatch):
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    assert distributed.local_rank() == 0
    assert distributed.local_rank(3) == 3
    monkeypatch.setenv("RANK", "5")
    assert distributed.local_rank() == 5
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert distributed.local_rank(3) == 1  # a launcher's local rank wins


def test_worker_refuses_cards_it_does_not_have(monkeypatch):
    """Process 1 of a host with two cards, two cards a process, would need
    cards 2 and 3: the worker says so instead of sharing a card."""
    from dart_planner_tpu_torch.parallel import worker

    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match=r"cards 2\.\.\.3, 2 visible"):
        worker.main(["--coordinator", "localhost:1", "--num-processes", "2",
                     "--process-id", "1", "--backend", "nccl", "--local-devices", "2"])


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0), torch.device("cuda", 1)


def _fleet(batch, device, config):
    rng = np.random.default_rng(7)
    obs = np.concatenate([rng.normal(0, 4, (batch, 4, 3)),
                          rng.uniform(0.3, 1.2, (batch, 4, 1))], -1).astype(np.float32)
    p0 = rng.normal(0, 2, (batch, 3)).astype(np.float32) + np.float32([0, 0, 5])
    v0 = rng.normal(0, 1, (batch, 3)).astype(np.float32)
    goal = rng.normal(0, 5, (batch, 3)).astype(np.float32) + np.float32([0, 0, 5])
    return se3_mpc.make_problem(p0, v0, goal, obstacles=obs, config=config, device=device)


@pytest.mark.cuda
def test_cuda_b1_on_the_second_card(two_cards):
    _, card1 = two_cards
    prob = _fleet(256, card1, ONE_ROUND)
    u0 = se3_mpc.initialize_thrusts(ONE_ROUND, prob)
    before = cuda_mpc.LAUNCHES
    k = cuda_mpc.solve_thrusts_fused(ONE_ROUND, prob, u0)
    torch.cuda.synchronize(card1)
    assert cuda_mpc.LAUNCHES == before + 1
    p = cuda_mpc.solve_thrusts_plain(ONE_ROUND, prob, u0)
    assert k[0].device == card1
    torch.testing.assert_close(k[0], p[0], atol=2e-3, rtol=0)


@pytest.mark.cuda
def test_cuda_b2_on_the_second_card(two_cards):
    _, card1 = two_cards
    B, T = 64, 8
    ctl = geometric.GeometricConfig(mass=1.5, max_thrust=25.0)
    phys = physics.PhysicsConfig(max_thrust=25.0)
    gen = torch.Generator().manual_seed(0)
    pos = (torch.randn(B, 3, generator=gen) + torch.tensor([0.0, 0.0, 3.0])).to(card1)
    rb = physics.RigidBodyState.from_drone_state(
        DroneState.zeros((B,), device=card1).replace(position=pos))
    S = cuda_rollout.pack_state(rb, geometric.ControllerState.zeros(ctl, (B,), device=card1))
    sp = (torch.randn(3 * T, B, generator=gen) * 0.3).to(card1)
    zero = torch.zeros(3 * T, B, device=card1)
    gw = torch.zeros(cuda_rollout.ACC_ROWS, B, device=card1)
    args = (ctl, phys, 0.0025, T, 1, S, sp, zero, zero, gw)
    before = cuda_rollout.LAUNCHES
    k_out, k_acc = cuda_rollout.run_tick_block(*args)
    torch.cuda.synchronize(card1)
    assert cuda_rollout.LAUNCHES == before + 1
    p_out, p_acc = cuda_rollout.run_tick_block_plain(*args)
    assert k_out.device == card1
    torch.testing.assert_close(k_out, p_out, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(k_acc, p_acc, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_fleet_over_two_cards(two_cards):
    card0, card1 = two_cards
    mesh = scenario.make_fleet_mesh([card0, card1])
    prob = _fleet(512, "cpu", FAST)
    before = cuda_mpc.LAUNCHES
    res, stats = scenario.solve_fleet(FAST, mesh, prob)
    assert cuda_mpc.LAUNCHES == before + 2  # one a shard
    assert [r.thrusts.device for r in res.shards] == [card0, card1]
    one = se3_mpc.solve(FAST, _fleet(512, card0, FAST))
    both = res.gather(card0)
    torch.testing.assert_close(both.thrusts, one.thrusts, atol=1e-6, rtol=0)
    torch.testing.assert_close(both.cost, one.cost, atol=0, rtol=1e-6)
    assert int(stats.total) == 512
    assert int(stats.converged) == int(one.converged.sum())
    plain, pstats = scenario.solve_fleet(FAST, mesh, prob, method="torch")
    assert abs(float(pstats.converged) - float(stats.converged)) <= 0.02 * 512
    np.testing.assert_allclose(float(pstats.mean_cost), float(stats.mean_cost), rtol=1e-3)


@pytest.mark.cuda
def test_cuda_two_nccl_processes_one_card_each(two_cards):
    from test_torch_distributed import _launch

    r = _launch(2, 1, 64, backend="nccl")
    assert r["process_count"] == 2 and r["global_devices"] == 2
    s, ref = r["stats"], r["reference"]
    assert s["total"] == ref["total"] == 64.0
    assert s["converged"] == ref["converged"]
    np.testing.assert_allclose(s["mean_cost"], ref["mean_cost"], rtol=1e-6)
