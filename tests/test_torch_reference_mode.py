"""The port's reference-equivalence mode (dart_planner_tpu_torch/planning/
reference_mode.py) against the JAX package's, and against the golden
outputs recorded from the reference implementation under scipy
(tests/fixtures/golden, read as tests/test_reference_equivalence.py reads
them, with its tolerances).

The closed form is a clip and two broadcasts, so the port equals JAX's
exactly on the same inputs.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from dart_planner_tpu.planning import se3_mpc as JM
from dart_planner_tpu.planning.reference_mode import solve_reference_mode as jax_solve
from dart_planner_tpu_torch.ops import so3
from dart_planner_tpu_torch.planning import se3_mpc as TM
from dart_planner_tpu_torch.planning.reference_mode import solve_reference_mode

GOLDEN_DIR = Path(__file__).parent / "fixtures" / "golden"
N = 20
CFG = TM.SE3MPCConfig(prediction_horizon=N, dt=0.1)


@pytest.mark.parametrize("gradient", ["reference", "exact"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_matches_jax_in_both_modes(gradient, dtype):
    rng = np.random.default_rng(0)
    goal = rng.normal(0, 80, (5, 3)).astype(dtype)  # some clip the envelope
    p0 = rng.normal(0, 1, (5, 3)).astype(dtype)
    jcfg = JM.SE3MPCConfig(prediction_horizon=N, min_thrust=15.0)
    ref = jax_solve(jcfg, p0, p0, goal, gradient=gradient)
    out = solve_reference_mode(TM.SE3MPCConfig(**jcfg._asdict()), p0, p0, goal,
                               gradient=gradient, device="cpu")
    for a, b in zip(out, ref):
        assert a.shape == (5, N, 3)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b, dtype))
    assert np.abs(out.positions.numpy()).max() == 100.0
    assert float(out.thrust_vectors[0, 0, 2]) == 15.0  # the floor binds


def test_unknown_gradient_raises():
    with pytest.raises(ValueError, match="gradient mode"):
        solve_reference_mode(CFG, np.zeros(3), np.zeros(3), np.zeros(3),
                             gradient="lbfgs", device="cpu")


def test_tensor_goal_keeps_its_device():
    out = solve_reference_mode(CFG, None, None, torch.tensor([1.0, 2.0, 3.0]))
    assert out.positions.device.type == "cpu" and out.positions.dtype == torch.float32


def test_matches_golden_converged():
    """Against the reference run until scipy's own criteria bind."""
    d = np.load(GOLDEN_DIR / "reference_n20_converged.npz")
    for i in range(len(d["goal"])):
        ours = solve_reference_mode(CFG, d["p0"][i], d["v0"][i], d["goal"][i], device="cpu")
        np.testing.assert_allclose(ours.positions.numpy(), d["positions"][i], atol=0.02,
                                   err_msg=f"case {i} positions")
        np.testing.assert_allclose(ours.velocities.numpy(), d["velocities"][i], atol=0.15,
                                   err_msg=f"case {i} velocities")
        np.testing.assert_allclose(ours.thrust_vectors.numpy()[:, :2],
                                   d["thrust_vectors"][i][:, :2], atol=1e-9,
                                   err_msg=f"case {i} thrust xy")
        # the reference stalls 0.35-0.48 N below hover (1.99 N where the goal
        # clips the envelope)
        atol_z = 2.1 if i in (15, 16) else 0.55
        np.testing.assert_allclose(ours.thrust_vectors.numpy()[:, 2],
                                   d["thrust_vectors"][i][:, 2], atol=atol_z,
                                   err_msg=f"case {i} thrust z")


def test_final_position_matches_shipped():
    """At the shipped 15-iteration budget the terminal step already sits on
    clip(goal)."""
    d = np.load(GOLDEN_DIR / "reference_n20.npz")
    for i in range(len(d["goal"])):
        ours = solve_reference_mode(CFG, d["p0"][i], d["v0"][i], d["goal"][i], device="cpu")
        np.testing.assert_allclose(ours.positions.numpy()[-1], d["positions"][i][-1],
                                   atol=0.02, err_msg=f"case {i}")


def test_attitude_extraction_matches_golden():
    """The port's SO(3) attitude and body-rate extraction fed the
    reference's recorded thrust vectors (float64), as the JAX test holds
    its own."""
    d = np.load(GOLDEN_DIR / "reference_n20.npz")
    for i in range(len(d["goal"])):
        T = torch.tensor(d["thrust_vectors"][i], dtype=torch.float64)
        Rs = so3.thrust_yaw_to_rotmat(T, torch.zeros(N, dtype=torch.float64))
        np.testing.assert_allclose(so3.rotmat_to_euler(Rs).numpy(), d["attitudes"][i],
                                   atol=1e-6, err_msg=f"case {i} attitudes")
        np.testing.assert_allclose(so3.body_rates_from_rotmats(Rs, 0.1).numpy(),
                                   d["body_rates"][i], atol=1e-5, err_msg=f"case {i} rates")
