"""The port's solver-quality diagnostics (scripts/diag_newton_decrement_torch.py,
diag_tail_torch.py, diag_stuck_torch.py, diag_fixes_torch.py) on the CPU,
against the JAX scripts they mirror, at batch 32, N=20, on the JAX scripts'
``make_batch`` draws (the port's ``make_batch`` makes the same numpy draws).

Solve rows branch at float32 near-ties (ROADMAP C, reference faults 7 and
9), so the deterministic functions are held on the same thrusts, JAX's
60-round ground-truth thrusts (the tail kept, as diag_tail.py,
diag_newton_decrement.py and diag_fixes.py solve it) cast to float32
(faults 8 and 10):

- ``newton_decrement`` against the JAX script's: rtol 1e-4, the cost at
  rtol 1e-5. At the ground truth most decrements are float32 rounding noise
  (1e-15 to 1e-9: the gradient of a converged minimum, rounded in each
  package's order of sums), so there an atol of 1e-10 stands beside the
  rtol, four orders below the smallest tolerance the script classifies by
  (1e-6; the largest difference measured is 3.3e-11). The same function
  is also held on JAX's cold start, where every decrement is large, at
  rtol 1e-4 alone;
- diag_tail's near-bound share of |pg|^2 within 1e-4 (absolute) on JAX's
  cold start in every scenario, and at the ground truth in its tail (the
  script's cohort, a decrement above 1e-5; elsewhere |pg|^2 is rounding
  noise and so is its share); its hinge-active mask (positions rolled out
  by each package from the same thrusts) equal in all but at most one
  scenario, a boundary tie;
- diag_stuck's suspicion ratio (the same cold start, JAX's, and the same
  cost, JAX's shipping solve) at rtol 1e-5, with the same rank and cohort
  verdict for JAX's worst-excess scenario over its tail-free ground truth
  (the cohort at capacity 1/32 of the batch, where the JAX script has
  4096 / 32);
- every config each JAX ``main`` hands to ``se3_mpc.solve`` (its batch
  patched to 32, the solve recorded and not run) equals, in order and field
  for field, what the port's ``main`` hands to the port's on the CPU: the
  grids of diag_tail and the variants of diag_fixes among them;
- each script's ``--device cpu`` run at batch 16 completes and prints its
  columns; without a card and without ``--device cpu`` each exits non-zero.
"""

import contextlib
import importlib.util
import io
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dart_planner_tpu.common import frames as jframes
from dart_planner_tpu.ops import costs as jcosts
from dart_planner_tpu.planning import se3_mpc as JS
from dart_planner_tpu_torch import interop
from dart_planner_tpu_torch.ops import dynamics
from dart_planner_tpu_torch.planning import se3_mpc as TS
from _torch_one_thread import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"
BATCH = 32
QUALITY = ("diag_newton_decrement", "diag_tail", "diag_stuck", "diag_fixes")


def _load(name):
    """scripts/<name>.py as a module (the scripts directory on sys.path, as
    the JAX scripts' own imports need)."""
    if str(SCRIPTS) not in sys.path:
        sys.path.insert(0, str(SCRIPTS))
    spec = importlib.util.spec_from_file_location(f"_script_{name}", SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _printed(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


@pytest.fixture(scope="module")
def batch():
    """JAX's batch and solves (the ground truths, the shipping solve), and
    the port's batch from the same draws."""
    config, prob = _load("diag_convergence").make_batch(BATCH)
    u0 = JS.initialize_thrusts(config, prob)
    gt_cfg = config._replace(max_iterations=60, cg_iterations=25)
    gt = JS.solve(gt_cfg, prob, u0, method="xla")
    gt0 = JS.solve(gt_cfg._replace(tail_iterations=0), prob, u0, method="xla")
    ship = JS.solve(config, prob, u0, method="xla")
    config_t, prob_t = _load("diag_convergence_torch").make_batch(BATCH, device="cpu")
    return {"config": config, "prob": prob, "gt_cfg": gt_cfg, "gt": gt, "gt0": gt0,
            "ship": ship, "config_t": config_t, "prob_t": prob_t,
            "u": np.asarray(gt.thrusts, np.float32)}


@pytest.mark.parametrize("thrusts,atol", [("ground_truth", 1e-10), ("cold_start", 0.0)])
def test_newton_decrement_matches_jax(batch, thrusts, atol):
    jnd = _load("diag_newton_decrement")
    port = _load("diag_newton_decrement_torch")
    u = batch["u"] if thrusts == "ground_truth" else np.asarray(
        JS.initialize_thrusts(batch["config"], batch["prob"]), np.float32)
    nd_j, cost_j = jax.jit(jnd.newton_decrement, static_argnums=0)(
        batch["gt_cfg"], batch["prob"], jnp.asarray(u))
    nd_t, cost_t = port.newton_decrement(batch["config_t"], batch["prob_t"], torch.tensor(u))
    if thrusts == "cold_start":
        assert float(np.min(np.asarray(nd_j))) > 1e-6
    np.testing.assert_allclose(nd_t.numpy(), np.asarray(nd_j, np.float32), rtol=1e-4, atol=atol)
    np.testing.assert_allclose(cost_t.numpy(), np.asarray(cost_j, np.float32), rtol=1e-5)


def _jax_bound_share(config, prob, u):
    """diag_tail.py's part (a): the near-bound share of |pg|^2."""
    N = config.prediction_horizon
    gvec = jframes.gravity_vector(jframes.WorldFrame.ENU, config.gravity).astype(jnp.float32)
    lb, ub = config.thrust_bounds(jnp.float32)
    lb_full, ub_full = jnp.broadcast_to(lb, (N, 3)), jnp.broadcast_to(ub, (N, 3))
    g = jcosts.condensed_grad(u, prob, config.weights, config.dt, config.mass, gvec)
    pg2 = np.asarray(jnp.clip(u - g, lb_full, ub_full) - u) ** 2
    near = np.asarray((u <= lb_full + 1e-2) | (u >= ub_full - 1e-2))
    return (pg2 * near).sum(axis=(-1, -2)) / np.maximum(pg2.sum(axis=(-1, -2)), 1e-12)


def test_tail_bound_share_and_hinge_mask_match_jax(batch):
    port = _load("diag_tail_torch")
    config, prob = batch["config"], batch["prob"]
    u_cold = np.asarray(JS.initialize_thrusts(config, prob), np.float32)
    nd = np.asarray(_load("diag_newton_decrement").newton_decrement(
        config, prob, jnp.asarray(batch["u"]))[0])
    tail = nd > 1e-5
    assert 0 < tail.sum() < BATCH
    for u, where in ((u_cold, slice(None)), (batch["u"], tail)):
        share_j = _jax_bound_share(config, prob, jnp.asarray(u))
        share_t = port.bound_share(batch["config_t"], batch["prob_t"], torch.tensor(u))
        np.testing.assert_allclose(share_t[where], share_j[where], atol=1e-4)

    pos_j = np.asarray(batch["gt"].positions)
    obs, mask = np.asarray(prob.obstacles), np.asarray(prob.obstacle_mask)
    d = np.linalg.norm(pos_j[:, None, :, :] - obs[:, :, None, :3], axis=-1)
    inside_j = ((d < obs[:, :, 3:4] + config.safety_margin) & mask[:, :, None]).any(axis=(1, 2))
    cfg_t = batch["config_t"]
    gvec_t = torch.tensor([0.0, 0.0, -cfg_t.gravity])
    pos_t, _, _ = dynamics.rollout_linear(torch.tensor(batch["u"]), batch["prob_t"].p0,
                                          batch["prob_t"].v0, cfg_t.dt, cfg_t.mass, gvec_t)
    inside_t = port.hinge_active(cfg_t, batch["prob_t"], pos_t)
    assert 0 < inside_j.sum() < BATCH
    assert int((inside_t != inside_j).sum()) <= 1


def test_stuck_suspicion_ratio_and_cohort_match_jax(batch):
    port = _load("diag_stuck_torch")
    config, prob = batch["config"], batch["prob"]
    cost = np.asarray(batch["ship"].cost, np.float64)
    gt0 = np.asarray(batch["gt0"].cost, np.float64)
    i = int(np.argmax((cost - gt0) / np.maximum(np.abs(gt0), 1e-9)))
    # diag_stuck.py's part 1, on JAX's cold start
    w_quad = config.weights._replace(obstacle=0.0, ground=0.0, velocity_bound=0.0, tilt=0.0,
                                     thrust_norm=0.0)
    gvec = jframes.gravity_vector(jframes.WorldFrame.ENU, config.gravity).astype(np.float32)
    u0 = JS.initialize_thrusts(config, prob)
    quad = np.asarray(jcosts.condensed_cost(u0, prob, w_quad, config.dt, config.mass, gvec),
                      np.float64)
    ratio_j = cost / np.maximum(quad, 1e-3)
    rank_j = int(np.sum(ratio_j > ratio_j[i]))
    size_j = int(np.ceil(BATCH / 32.0))

    u0_t = torch.tensor(np.asarray(u0, np.float32))
    ratio_t = port.suspicion_ratio(batch["config_t"], batch["prob_t"], u0_t, cost)
    np.testing.assert_allclose(ratio_t, ratio_j, rtol=1e-5)
    assert port.cohort(ratio_t, i) == (rank_j, size_j, rank_j < size_j)


def _fake_result(make, u, B, N):
    z = make.zeros((B, N, 3))
    return make.result(thrusts=u, positions=z, velocities=z, accelerations=z,
                       cost=make.ones((B,)), converged=make.zeros((B,), bool),
                       grad_norm=make.zeros((B,)))


class _Jax:
    result = JS.SolveResult

    @staticmethod
    def zeros(shape, dtype=jnp.float32):
        return jnp.zeros(shape, dtype)

    @staticmethod
    def ones(shape):
        return jnp.ones(shape, jnp.float32)


class _Torch:
    result = TS.SolveResult

    @staticmethod
    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype)

    @staticmethod
    def ones(shape):
        return torch.ones(shape)


@pytest.mark.parametrize("name", QUALITY)
def test_solve_configs_match_the_jax_script(name, monkeypatch):
    jax_calls, port_calls = [], []

    def jax_solve(cfg, prob, u=None, use_obstacles=True, method="auto"):
        jax_calls.append((cfg, method))
        return _fake_result(_Jax, jnp.asarray(u, jnp.float32), prob.p0.shape[0],
                            cfg.prediction_horizon)

    def port_solve(cfg, prob, u=None, use_obstacles=True, method="auto"):
        port_calls.append((cfg, method))
        return _fake_result(_Torch, u.clone(), prob.p0.shape[0], cfg.prediction_horizon)

    script = _load(name)
    small = _load("diag_convergence").make_batch
    monkeypatch.setattr(script, "make_batch", lambda *a, **k: small(BATCH))
    monkeypatch.setattr(JS, "solve", jax_solve)
    # diag_stuck.py points jax's compilation cache under the home directory
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    _printed(script.main)
    monkeypatch.setattr(TS, "solve", port_solve)
    _printed(_load(f"{name}_torch").main, ["--device", "cpu", "--batch", str(BATCH)])

    assert [m for _, m in jax_calls] == ["xla"] * len(jax_calls)
    assert [m for _, m in port_calls] == ["torch"] * len(jax_calls)
    assert [c for c, _ in port_calls] == [interop.config_from_jax_fields(c)
                                          for c, _ in jax_calls]


def test_grids_and_variants_are_the_jax_scripts():
    tail, fixes = _load("diag_tail_torch"), _load("diag_fixes_torch")
    config = TS.SE3MPCConfig()
    assert list(tail.grids(config)) == ["default(6)", "wide(12)", "overrelax(8)"]
    assert tail.grids(config)["default(6)"] == config.line_search_alphas
    assert [len(g) for g in tail.grids(config).values()] == [6, 12, 8]
    assert list(fixes.VARIANTS) == ["base-12", "base-16", "fullH-12", "fullH-16", "wideLS-12",
                                    "fullH+wideLS-12", "fullH+wideLS-16"]
    assert fixes.VARIANTS["wideLS-12"]["line_search_alphas"] == tail.WIDE


COLUMNS = {
    "diag_newton_decrement": ("GT newton-decrement percentiles 50/90/95/99:",
                              "torch newton=20 tol=1e-06: conv=", "excess among CONVERGED max="),
    "diag_tail": ("tail fraction at 12 iters:", "near-bound coords p50/p90:",
                  "hinge-active (inside margin) fraction: tail=",
                  "iters  tail-median-excess  tail-p95-excess", "grid overrelax(8) : conv(ftol)="),
    "diag_stuck": ("stuck scenario #", "suspicion ratio=", "cohort size 1;",
                   "jittered starts reaching within 5% of gt", "noise std  8.0 N: good="),
    "diag_fixes": ("gt done", "fullH+wideLS-16    conv=", "p95ex=", "maxex="),
}


@pytest.mark.parametrize("name", QUALITY)
def test_cpu_run_prints_the_columns(name):
    out, printed = _printed(_load(f"{name}_torch").main, ["--device", "cpu", "--batch", "16"])
    assert printed.startswith("platform=cpu (cpu, host clock) batch=16 horizon=20")
    for column in COLUMNS[name]:
        assert column in printed, (column, printed)
    assert out["device"] == "cpu, host clock"


@pytest.mark.parametrize("name", QUALITY)
def test_without_a_card_it_exits_non_zero(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script runs there")
    r = subprocess.run([sys.executable, str(SCRIPTS / f"{name}_torch.py"), "--batch", "4"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "--device cpu" in r.stderr
    assert "platform=" not in r.stdout
