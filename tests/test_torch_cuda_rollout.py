"""The port's tick-block kernel module (dart_planner_tpu_torch/ops/
cuda_rollout.py).

On the CPU: the wrapper's rule (CPU tensors run the plain version and do
not count as launches), the closed loop's packed path on CPU tensors, and
the bookkeeping around the kernel (its source and the TPU kernel it
replaces exist, the parameter struct matches the C one field by field, the
shared memory a block takes and the largest T it allows, the cached
parameter struct and interpolation weights).
On a CUDA device (tests marked ``cuda``): the hand-written kernel against
``run_tick_block_plain`` on the same rows, every float row at atol 1e-4 +
rtol 1e-4 (nvcc contracts into FMAs; the plain version does not), R
orthonormal to 1e-5, and at most 0.1% of episodes parting on the exact
compares of the torque-saturation and failsafe rows; in each of its arms
(back-calculation anti-windup, the "reference" yaw convention) and past
the ticks one launch holds, where a block runs as ``ceil(T / max_ticks)``
launches. Nothing here imports JAX, so the CUDA tests run on a machine
without it:

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
from dart_planner_tpu_torch.common.metrics import get_metrics
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


def _args(T, sub, rows, obs, trigger=100, **control):
    ctrl = BASE.control._replace(failsafe_trigger_count=trigger, **control)
    return (ctrl, BASE.physics, BASE.control_dt, T, sub, *rows, obs)


def _back_calc_rows(rows, seed):
    """Rows 26-29 of a back-calculating state: a last raw thrust of 0-40 N
    (the cap is 25) and raw torques ~ N(0, 8), so both feedbacks are live."""
    g = torch.Generator().manual_seed(seed)
    S = rows[0]
    S[26] = (torch.rand(S.shape[1], generator=g) * 40).to(S.device)
    S[27:30] = (torch.randn(3, S.shape[1], generator=g) * 8).to(S.device)
    return rows


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
    """Both anti-windup methods (the name is the test's from when the block
    took clamping only): back-calculation carries the last raw thrust and
    torque in rows 26-29 and integrates otherwise than clamping."""
    rows, obs = _rows(2, 2, 1, 3)
    rows = _back_calc_rows(rows, 3)
    clamp = cuda_rollout.run_tick_block_plain(*_args(2, 1, rows, obs))
    back_args = _args(2, 1, rows, obs, anti_windup_method="back_calculation")
    back = cuda_rollout.run_tick_block_plain(*back_args)
    assert torch.equal(cuda_rollout.run_tick_block(*back_args)[0], back[0])
    assert (clamp[0][26:] == 0).all() and (back[0][30:] == 0).all()
    assert torch.isfinite(back[0]).all() and (back[0][26] > 0).all()
    assert (back[0][27:30] != 0).all()
    assert not torch.equal(back[0][18:21], clamp[0][18:21])


def test_fused_closed_loop_on_cpu_launches_no_kernel():
    config = BASE._replace(
        mpc=se3_mpc.SE3MPCConfig(prediction_horizon=8, max_iterations=2,
                                 tail_iterations=0),
        num_replans=2, substeps_per_plan=10,
    )
    st = DroneState.zeros((2,), device="cpu").replace(position=torch.tensor([[0.0, 0, 3], [1, 0, 3]]))
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


def test_shared_memory_and_tick_limit_arithmetic(monkeypatch):
    """max_ticks is the largest T whose block fits a limit, and ticks_fit
    asks the card only above the 48 KB every card gives a block."""
    assert cuda_rollout.shared_bytes(40) == 4 * 32 * (3 * 40 + 3 * 4) == 16896
    assert cuda_rollout.max_ticks(232448) == 601  # an H100's opt-in limit
    for limit in (16896, 48 * 1024, 100_000, 232448, 232448 + 383):
        T = cuda_rollout.max_ticks(limit)
        assert cuda_rollout.shared_bytes(T) <= limit < cuda_rollout.shared_bytes(T + 1)
    assert cuda_rollout.max_ticks(16896) == 40 and cuda_rollout.max_ticks(16895) == 39
    cuda = torch.device("cuda", 0)
    asked = []

    def limit(device):
        asked.append(device)
        return 232448

    monkeypatch.setattr(cuda_rollout, "shared_limit", limit)
    small = cuda_rollout.max_ticks(cuda_rollout.DEFAULT_SHARED_BYTES)
    assert small == 124 and cuda_rollout.ticks_fit(small, cuda) and not asked
    assert cuda_rollout.ticks_fit(601, cuda) and not cuda_rollout.ticks_fit(602, cuda)
    assert asked == [cuda, cuda]


def test_launch_params_are_built_once_per_configuration():
    key = (BASE.control, BASE.physics, 0.0025, 40, 1, 2048, 3)
    first = cuda_rollout._launch_params(*key)
    again = cuda_rollout._launch_params(*key)
    assert again is first
    fresh = cuda_rollout._params(
        cuda_rollout._scalars(BASE.control, BASE.physics, 0.0025, 1), 2048, 40, 1, 3)
    assert bytes(first) == bytes(fresh)
    other = cuda_rollout._launch_params(*key[:5], 2047, 3)
    assert other is not first and other.B == 2047


def test_setpoint_weights_are_copied_once_and_keep_their_values():
    rng = np.random.default_rng(4)
    plan = [torch.as_tensor(rng.normal(0, 2, (5, 20, 3)).astype(np.float32))
            for _ in range(3)]
    first = cuda_rollout.setpoints_from_plan(*plan, 40, 0.0025, 0.1)
    uploads = get_metrics().all_summaries()["counters"].get("device_constant_uploads", 0)
    again = cuda_rollout.setpoints_from_plan(*plan, 40, 0.0025, 0.1)
    assert get_metrics().all_summaries()["counters"].get("device_constant_uploads", 0) == uploads
    W = cuda_rollout._lerp_tensor(40, 0.0025, 0.1, 20, torch.float32, torch.device("cpu"))
    assert W is cuda_rollout._lerp_tensor(40, 0.0025, 0.1, 20, torch.float32,
                                          torch.device("cpu"))
    W_fresh = torch.as_tensor(cuda_rollout._lerp_weights(40, 0.0025, 0.1, 20))
    assert torch.equal(W, W_fresh)
    for a, b, arr in zip(first, again, plan):
        assert torch.equal(a, b)
        ref = torch.einsum("tn,bnd->btd", W_fresh, arr).reshape(5, 120).T
        assert torch.equal(a, ref)


def test_launch_refuses_cpu_tensors():
    rows, obs = _rows(4, 3, 1, 5)
    before = cuda_rollout.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_rollout.launch_tick_block(None, *_args(3, 1, rows, obs))
    assert cuda_rollout.LAUNCHES == before


# ---- CUDA ---------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _compare(args, B, trigger, ortho_tol=1e-5, long_block=False):
    T, device = args[3], args[5].device
    before = cuda_rollout.LAUNCHES
    ks, ka = cuda_rollout.run_tick_block(*args)
    torch.cuda.synchronize()
    launches = -(-T // cuda_rollout.max_ticks(cuda_rollout.shared_limit(device)))
    assert cuda_rollout.LAUNCHES == before + launches
    assert len(cuda_rollout.tick_chunks(T, device)) == launches
    ps, pa = cuda_rollout.run_tick_block_plain(*args)
    assert torch.isfinite(ks).all() and torch.isfinite(ka).all()
    zero_from = 30 if cuda_rollout.back_calculation(args[0]) else 26
    assert (ks[zero_from:] == 0).all() and (ka[4:] == 0).all()
    parted = (ks[21:25] != ps[21:25]).any(0)
    allowed = max(1, int(0.001 * B))
    if long_block:
        # past a replan's 40 ticks an episode whose float rows part counts
        # as parted (a near-tie at a branch the rows do not show, a fresh
        # chance every tick: the integral's decay near its cap, the tilt
        # limit), 0.1% of the episodes for every 40 ticks
        parted |= torch.maximum(((ks - ps).abs() - 1e-4 * ps.abs()).amax(0),
                                ((ka - pa).abs() - 1e-4 * pa.abs()).amax(0)) > 1e-4
        allowed = max(1, int(0.001 * B * T / 40))
    assert int(parted.sum()) <= allowed
    keep = ~parted
    for k, p in ((ks, ps), (ka, pa)):
        torch.testing.assert_close(k[:, keep], p[:, keep], atol=1e-4, rtol=1e-4)
    R = ks[9:18].T.reshape(B, 3, 3)
    ortho = (torch.einsum("bij,bkj->bik", R, R) - torch.eye(3, device=R.device)).abs().max()
    assert float(ortho) <= ortho_tol
    return ks, ka, ps


@pytest.mark.cuda
@pytest.mark.parametrize("T, sub, K, trigger, drag", [
    (40, 1, 3, 100, 0.0), (25, 2, 3, 100, 0.0), (40, 1, 3, 10, 0.0), (40, 1, 0, 100, 0.0),
    (1, 1, 3, 100, 0.0), (1, 3, 0, 100, 0.0), (9, 2, 8, 100, 0.0), (9, 3, 8, 100, 0.4),
    (40, 1, 3, 100, 0.4),
])
def test_cuda_tick_block_matches_plain(cuda_device, T, sub, K, trigger, drag):
    """Ticks 1-40 (at T=1 three of the metrics pass's warps get no tick),
    1-3 substeps, the failsafe latch, no spheres or 8 with some switched
    off (all of episode 0's), and wind with or without linear drag."""
    B = 256
    rows, obs = _rows(B, T, K, T + sub + K + trigger, trigger, cuda_device)
    if K == 8:
        radius = obs[3::4]  # (K, B) view
        radius[1::2, ::3] = cuda_rollout.INACTIVE_RADIUS
        radius[:, 0] = cuda_rollout.INACTIVE_RADIUS
    args = list(_args(T, sub, rows, obs, trigger))
    args[1] = BASE.physics._replace(drag_coefficient=drag)
    ks, ka, ps = _compare(args, B, trigger)
    if trigger == 10:
        assert (ps[24] > trigger).any()  # the latch fired
    if K == 0:
        assert (ka[3] == 1e30).all()
    if K == 8:
        assert float(ka[3, 0]) >= 1e30 and bool((ka[3, 1:] < 1e30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("T, sub, K, trigger, control", [
    (40, 1, 3, 100, dict(anti_windup_method="back_calculation")),
    (40, 1, 3, 10, dict(anti_windup_method="back_calculation")),
    (40, 1, 3, 100, dict(yaw_convention="reference")),
    (25, 2, 0, 100, dict(yaw_convention="reference")),
    (9, 3, 8, 10, dict(anti_windup_method="back_calculation", yaw_convention="reference")),
])
def test_cuda_tick_block_arms_match_plain(cuda_device, T, sub, K, trigger, control):
    """Each of the kernel's compile-time arms: back-calculation (with rows
    26-29 live, and with the failsafe latch), the reference yaw, both."""
    B = 256
    rows, obs = _rows(B, T, K, T + sub + K + trigger, trigger, cuda_device)
    if "anti_windup_method" in control:
        rows = _back_calc_rows(rows, T + trigger)
    ks, _, ps = _compare(_args(T, sub, rows, obs, trigger, **control), B, trigger)
    if trigger == 10:
        assert (ps[24] > trigger).any()
    lee = cuda_rollout.run_tick_block(*_args(T, sub, rows, obs, trigger))[0]
    assert not torch.equal(lee, ks)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 31, 32, 33, 65, 130, 2048])
def test_cuda_tick_block_shapes_and_odd_batch(cuda_device, B):
    """Blocks hold 32 episodes: a last block partly empty, exactly full or
    one episode over; and a batch of none."""
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
@pytest.mark.parametrize("field", ["yaw_convention", "substeps_per_plan"])
def test_cuda_closed_loop_out_of_kernel_scope_raises(cuda_device, field):
    """A "reference" yaw convention, or more ticks a replan than B2's block
    holds in shared memory, once outside B2's scope (the name is the
    test's from then), now runs through it: the fused and auto episodes
    launch B1 once a replan and B2 ``ceil(T / max_ticks)`` times, and fly as
    the plain per-tick path ("torch", no launch) does, final positions to
    1e-3 m (B1 against the plain solve, figure-8's limit)."""
    config = BASE._replace(
        mpc=se3_mpc.SE3MPCConfig(prediction_horizon=8, max_iterations=2,
                                 tail_iterations=0),
        num_replans=2, substeps_per_plan=10,
    )
    if field == "yaw_convention":
        config = config._replace(control=BASE.control._replace(yaw_convention="reference"))
    else:
        T = cuda_rollout.max_ticks(cuda_rollout.shared_limit(cuda_device)) + 1
        config = config._replace(num_replans=1, substeps_per_plan=T)
    st = DroneState.zeros((2,), device=cuda_device).replace(
        position=torch.tensor([[0.0, 0, 3], [1, 0, 3]], device=cuda_device))
    goals = torch.tensor([[3.0, 0, 3], [3.0, 1, 4]], device=cuda_device)
    R, T = config.num_replans, config.substeps_per_plan
    per_replan = -(-T // cuda_rollout.max_ticks(cuda_rollout.shared_limit(cuda_device)))
    assert per_replan == (2 if field == "substeps_per_plan" else 1)
    before = (cuda_mpc.LAUNCHES, cuda_rollout.LAUNCHES)
    res = closed_loop.simulate_episode(config, None, st, goals, method="torch")
    assert (cuda_mpc.LAUNCHES, cuda_rollout.LAUNCHES) == before
    for method in ("fused", "auto"):
        before = (cuda_mpc.LAUNCHES, cuda_rollout.LAUNCHES)
        fused = closed_loop.simulate_episode(config, None, st, goals, method=method)
        torch.cuda.synchronize()
        assert (cuda_mpc.LAUNCHES - before[0], cuda_rollout.LAUNCHES - before[1]) == (
            R, R * per_replan)
        assert fused.final_position.device.type == "cuda"
        torch.testing.assert_close(fused.final_position, res.final_position, atol=1e-3,
                                   rtol=0)


def _steady_rows(B, T, seed, device):
    """States as in _rows, holding their own position (zero velocity and
    acceleration setpoints): a stable run over many ticks."""
    rows, obs = _rows(B, 1, 2, seed, device=device)
    S, gw = rows[0], rows[4]
    spp = S[0:3].repeat(T, 1).contiguous()
    zero = torch.zeros_like(spp)
    return [S, spp, zero, zero.clone(), gw], obs


@pytest.mark.cuda
@pytest.mark.parametrize("T", [40, 200, "largest"])
def test_cuda_tick_block_at_the_largest_T(cuda_device, T):
    """Long blocks up to the largest T the card's shared memory takes."""
    largest = cuda_rollout.max_ticks(cuda_rollout.shared_limit(cuda_device))
    T = largest if T == "largest" else T
    assert 200 <= largest and T <= largest
    # float32 Rodrigues updates drift off SO(3) a little every tick, in the
    # kernel and the plain version alike. Read on an H100 over these seeds,
    # the kernel's |R R^T - I| was at most 1.79e-6 at T=40, 6.32e-6 at 200
    # and 2.34e-5 at 601 (the plain version's 2.03e-6, 8.58e-6, 2.13e-5):
    # 3.2-4.5e-8 a tick. The limit, 1e-7 a tick, is 2.2-3.2x those readings.
    for seed in (8, 9, 10, 11):
        rows, obs = _steady_rows(33, T, seed, cuda_device)
        _compare(_args(T, 1, rows, obs), 33, 100, ortho_tol=1e-7 * T)


@pytest.mark.cuda
@pytest.mark.parametrize("over", [1, "1000"])
def test_cuda_tick_block_above_the_largest_T_raises_before_a_launch(cuda_device, over):
    """Past the largest T one launch holds (the name is the test's from when
    it raised there): one tick more, and T=1000, run as two launches, the
    state chained between them, against the plain version chunked the same
    way."""
    largest = cuda_rollout.max_ticks(cuda_rollout.shared_limit(cuda_device))
    T = largest + 1 if over == 1 else int(over)
    assert cuda_rollout.tick_chunks(T, cuda_device) == (largest, T - largest)
    rows, obs = _steady_rows(33, T, 9, cuda_device)
    _compare(_args(T, 1, rows, obs, anti_windup_method="back_calculation"), 33, 100,
             ortho_tol=1e-7 * T, long_block=True)
