"""The port's tick-block kernel module (dart_planner_tpu_torch/ops/
cuda_rollout.py).

On the CPU: the wrapper's rule (CPU tensors run the plain version and do
not count as launches), the closed loop's packed path on CPU tensors, and
the bookkeeping around the kernel (its source and the TPU kernel it
replaces exist, the parameter struct matches the C one field by field).
On a CUDA device (tests marked ``cuda``): the hand-written kernel against
``run_tick_block_plain`` on the same rows, every float row at atol 1e-4 +
rtol 1e-4 (nvcc contracts into FMAs; the plain version does not), R
orthonormal to 1e-5, and at most 0.1% of episodes parting on the exact
compares of the torque-saturation and failsafe rows. Nothing here imports
JAX, so the CUDA tests run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_cuda_rollout.py -m cuda
"""

import ctypes
import pathlib
import re

import numpy as np
import pytest
import torch

from dart_planner_tpu_torch import DroneState
from dart_planner_tpu_torch.ops import cuda_mpc, cuda_rollout, so3
from dart_planner_tpu_torch.planning import se3_mpc
from dart_planner_tpu_torch.sim import ClosedLoopConfig, closed_loop

ROOT = pathlib.Path(__file__).resolve().parents[1]
BASE = ClosedLoopConfig()


def _rows(B, T, K, seed, trigger=100, device="cpu"):
    """Random but physical tick-block inputs: states with attitudes up to
    +-0.5 rad and fast rates, setpoints near the states, goal and wind, and
    K spheres per episode (the first inactive in every 5th episode)."""
    rng = np.random.default_rng(seed)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    S = torch.zeros(32, B)
    S[0:3] = f32(rng.normal(0, 1, (3, B)) + [[0], [0], [4]])
    S[3:6] = f32(rng.normal(0, 2, (3, B)))
    S[6:9] = f32(rng.normal(0, 2, (3, B)))
    R = so3.euler_to_rotmat(f32(rng.uniform(-0.5, 0.5, (B, 3))))
    S[9:18] = R.reshape(B, 9).T
    S[18:21] = f32(rng.uniform(-1.5, 1.5, (3, B)))
    S[21:24] = f32(rng.integers(0, 2, (3, B)))
    S[24] = f32(rng.integers(0, trigger + 20, B))
    S[25] = f32(rng.uniform(10, 20, B))
    spp = (S[0:3][None] + f32(rng.normal(0, 1.0, (T, 3, B)))).reshape(3 * T, B)
    spv = f32(rng.normal(0, 1.5, (3 * T, B)))
    spa = f32(rng.normal(0, 2.5, (3 * T, B)))
    gw = torch.zeros(8, B)
    gw[0:3] = f32(rng.normal(0, 3, (3, B)))
    gw[3:6] = f32(rng.normal(0, 1, (3, B)))
    obs = None
    if K:
        spheres = torch.cat([S[0:3].T[:, None, :] + f32(rng.normal(0, 1.5, (B, K, 3))),
                             f32(rng.uniform(0.3, 0.8, (B, K, 1)))], dim=-1)
        mask = torch.ones(B, K, dtype=torch.bool)
        mask[::5, 0] = False
        obs = cuda_rollout.pack_obstacles(spheres, mask).to(device)
    rows = [x.contiguous().to(device) for x in (S, spp, spv, spa, gw)]
    return rows, obs


def _args(T, sub, rows, obs, trigger=100):
    ctrl = BASE.control._replace(failsafe_trigger_count=trigger)
    return (ctrl, BASE.physics, BASE.control_dt, T, sub, *rows, obs)


# ---- CPU --------------------------------------------------------------------

def test_cpu_tensors_run_the_plain_version_and_do_not_count():
    rows, obs = _rows(6, 5, 2, 0)
    before = cuda_rollout.LAUNCHES
    out = cuda_rollout.run_tick_block(*_args(5, 1, rows, obs))
    ref = cuda_rollout.run_tick_block_plain(*_args(5, 1, rows, obs))
    assert cuda_rollout.LAUNCHES == before
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert out[0].shape == (32, 6) and out[1].shape == (8, 6)
    assert (out[0][26:] == 0).all() and (out[1][4:] == 0).all()


def test_plain_version_without_spheres_reports_no_clearance():
    rows, _ = _rows(4, 3, 0, 1)
    _, acc = cuda_rollout.run_tick_block(*_args(3, 2, rows, None))
    assert (acc[3] == 1e30).all()
    assert torch.isfinite(acc[:3]).all()


def test_inactive_sphere_never_wins_the_minimum():
    rows, _ = _rows(2, 3, 0, 2)
    spheres = torch.tensor([[[0.0, 0.0, 4.0, 0.5], [50.0, 0.0, 0.0, 0.5]]] * 2)
    mask = torch.tensor([[False, True], [True, True]])
    obs = cuda_rollout.pack_obstacles(spheres, mask)
    assert obs[3, 0] == cuda_rollout.INACTIVE_RADIUS
    _, acc = cuda_rollout.run_tick_block(*_args(3, 1, rows, obs))
    assert acc[3, 0] > 40.0 and acc[3, 1] < 5.0


def test_tick_block_takes_clamping_anti_windup_only():
    rows, obs = _rows(2, 2, 1, 3)
    args = list(_args(2, 1, rows, obs))
    args[0] = args[0]._replace(anti_windup_method="back_calculation")
    with pytest.raises(ValueError, match="clamping"):
        cuda_rollout.run_tick_block_plain(*args)


def test_fused_closed_loop_on_cpu_launches_no_kernel():
    config = BASE._replace(
        mpc=se3_mpc.SE3MPCConfig(prediction_horizon=8, max_iterations=2,
                                 tail_iterations=0),
        num_replans=2, substeps_per_plan=10,
    )
    st = DroneState.zeros((2,)).replace(position=torch.tensor([[0.0, 0, 3], [1, 0, 3]]))
    goals = torch.tensor([[3.0, 0, 3], [3.0, 1, 4]])
    before = (cuda_mpc.LAUNCHES, cuda_rollout.LAUNCHES)
    res = closed_loop.simulate_episode(config, None, st, goals, method="fused")
    assert (cuda_mpc.LAUNCHES, cuda_rollout.LAUNCHES) == before
    assert torch.isfinite(res.final_position).all()


def test_kernel_source_and_replaced_kernel_exist():
    src = ROOT / cuda_rollout.SOURCE
    assert src.is_file() and src.suffix == ".cu"
    text = src.read_text()
    assert "pallas_rollout.py" in text and "run_tick_block" in text
    path, line = cuda_rollout.REPLACES.split(":")
    lines = (ROOT / path).read_text().splitlines()
    assert lines[int(line) - 1].startswith("def run_tick_block(")
    assert "pl.pallas_call" in (ROOT / path).read_text()


def test_params_struct_matches_the_c_struct():
    """ctypes' _Params against struct TickParams, field by field."""
    text = (ROOT / cuda_rollout.SOURCE).read_text()
    body = re.search(r"struct TickParams \{(.*?)\};", text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    c_fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        ctype, names = decl.split(None, 1)
        for name in names.split(","):
            m = re.fullmatch(r"\s*(\w+)(?:\[(\d+)\])?\s*", name)
            c_fields.append((m.group(1), ctype, int(m.group(2) or 1)))
    py_fields = []
    for name, t in cuda_rollout._Params._fields_:
        n = getattr(t, "_length_", 1)
        base = t._type_ if n > 1 else t
        py_fields.append((name, "int" if base is ctypes.c_int else "float", n))
    assert c_fields == py_fields
    p = cuda_rollout._params(
        cuda_rollout._scalars(BASE.control, BASE.physics, 0.0025, 2), 7, 40, 2, 3
    )
    assert (p.B, p.T, p.substeps, p.K, p.use_drag) == (7, 40, 2, 3, 0)
    assert abs(p.h - 0.00125) < 1e-9 and abs(p.near_int[2] - 3.0 * 0.95) < 1e-6
    assert abs(p.min_thrust - 0.5 * 1.5 * 9.81) < 1e-5


# ---- CUDA ---------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _compare(args, B, trigger):
    before = cuda_rollout.LAUNCHES
    ks, ka = cuda_rollout.run_tick_block(*args)
    torch.cuda.synchronize()
    assert cuda_rollout.LAUNCHES == before + 1
    ps, pa = cuda_rollout.run_tick_block_plain(*args)
    assert torch.isfinite(ks).all() and torch.isfinite(ka).all()
    parted = (ks[21:25] != ps[21:25]).any(0)
    assert int(parted.sum()) <= max(1, int(0.001 * B))
    keep = ~parted
    for k, p in ((ks, ps), (ka, pa)):
        torch.testing.assert_close(k[:, keep], p[:, keep], atol=1e-4, rtol=1e-4)
    R = ks[9:18].T.reshape(B, 3, 3)
    ortho = (torch.einsum("bij,bkj->bik", R, R) - torch.eye(3, device=R.device)).abs().max()
    assert float(ortho) <= 1e-5
    return ks, ka, ps


@pytest.mark.cuda
@pytest.mark.parametrize("T, sub, K, trigger", [
    (40, 1, 3, 100), (25, 2, 3, 100), (40, 1, 3, 10), (40, 1, 0, 100),
])
def test_cuda_tick_block_matches_plain(cuda_device, T, sub, K, trigger):
    B = 256
    rows, obs = _rows(B, T, K, T + sub + K + trigger, trigger, cuda_device)
    ks, ka, ps = _compare(_args(T, sub, rows, obs, trigger), B, trigger)
    if trigger == 10:
        assert (ps[24] > trigger).any()  # the latch fired
    if K == 0:
        assert (ka[3] == 1e30).all()


@pytest.mark.cuda
def test_cuda_tick_block_shapes_and_odd_batch(cuda_device):
    for B in (1, 65, 130):
        rows, obs = _rows(B, 7, 2, B, device=cuda_device)
        _compare(_args(7, 1, rows, obs), B, 100)
    rows, _ = _rows(0, 3, 0, 0, device=cuda_device)
    out, acc = cuda_rollout.run_tick_block(*_args(3, 1, rows, None))
    assert out.shape == (32, 0) and acc.shape == (8, 0)


@pytest.mark.cuda
def test_cuda_tick_block_rejects_what_it_does_not_take(cuda_device):
    rows, obs = _rows(8, 4, 2, 0, device=cuda_device)
    before = cuda_rollout.LAUNCHES
    bad = [
        (TypeError, [rows[0].double()] + rows[1:], obs),
        (ValueError, [rows[0]] + [rows[1][:-3]] + rows[2:], obs),  # 3T rows
        (ValueError, rows, obs[:-1]),  # 4K rows
        (ValueError, [rows[0].T.contiguous().T] + rows[1:], obs),  # layout
        (ValueError, [rows[0], rows[1].cpu()] + rows[2:], obs),  # device
    ]
    for exc, r, o in bad:
        with pytest.raises(exc):
            cuda_rollout.run_tick_block(*_args(4, 1, r, o))
    assert cuda_rollout.LAUNCHES == before


@pytest.mark.cuda
def test_cuda_closed_loop_launches_both_kernels_once_per_replan(cuda_device):
    config = BASE._replace(
        mpc=se3_mpc.SE3MPCConfig(prediction_horizon=8, max_iterations=3,
                                 tail_iterations=0),
        num_replans=5, wind_mean=1.0, wind_std=0.3,
    )
    B = 64
    gen, st, goals = closed_loop.sample_fleet(
        torch.Generator().manual_seed(0), B, torch.tensor([0.0, 0, 3], device=cuda_device),
        torch.tensor([4.0, 2, 4], device=cuda_device), 1.0, 1.0,
    )
    before = (cuda_mpc.LAUNCHES, cuda_rollout.LAUNCHES)
    res = closed_loop.simulate_episode(config, gen, st, goals, method="auto")
    torch.cuda.synchronize()
    assert (cuda_mpc.LAUNCHES - before[0], cuda_rollout.LAUNCHES - before[1]) == (5, 5)
    assert res.final_position.device.type == "cuda"
    assert torch.isfinite(res.final_position).all() and torch.isfinite(res.tracking_rmse).all()
    assert float(res.tracking_rmse.max()) < 1.0


@pytest.mark.cuda
def test_cuda_closed_loop_out_of_kernel_scope_raises(cuda_device):
    """A "reference" yaw convention is outside B2's scope: on the card the
    fused and auto episodes raise before any launch, and "torch" runs the
    plain per-tick loop when asked for."""
    config = BASE._replace(
        mpc=se3_mpc.SE3MPCConfig(prediction_horizon=8, max_iterations=2,
                                 tail_iterations=0),
        num_replans=2, substeps_per_plan=10,
        control=BASE.control._replace(yaw_convention="reference"),
    )
    st = DroneState.zeros((2,), device=cuda_device).replace(
        position=torch.tensor([[0.0, 0, 3], [1, 0, 3]], device=cuda_device))
    goals = torch.tensor([[3.0, 0, 3], [3.0, 1, 4]], device=cuda_device)
    before = (cuda_mpc.LAUNCHES, cuda_rollout.LAUNCHES)
    for method in ("fused", "auto"):
        with pytest.raises(ValueError, match="yaw_convention"):
            closed_loop.simulate_episode(config, None, st, goals, method=method)
    res = closed_loop.simulate_episode(config, None, st, goals, method="torch")
    assert (cuda_mpc.LAUNCHES, cuda_rollout.LAUNCHES) == before
    assert res.final_position.device.type == "cuda"
    assert torch.isfinite(res.final_position).all()
