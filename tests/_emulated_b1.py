"""Kernel B1's own source compiled by g++ for the CPU, as nvcc builds it,
for the tests of its wrapper (``cuda_mpc.run_library``): a module of its
own, without JAX, so that the test files of the port's tracing, of long
horizons and of the packed arm share it, with the bench batch and the
one-round check against the plain twin that they hold it to.

``csrc/mpc_solve.cu`` and ``csrc/mpc_solve_steps.cu`` (which includes it)
are compiled (C++20) as two translation units against
``csrc/emulation/cuda_runtime.h`` and bound with the kernel's C interface:
its one ``<<<...>>>`` launch becomes a call of the header's launcher;
``-mfma -ffp-contract=fast`` contracts into FMAs as nvcc does, square roots
and divisions stay IEEE as nvcc's defaults. A 16-scenario round at N=128
takes about a tenth of a second (the build, about six).
"""

import ctypes
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from dart_planner_tpu_torch.ops import _build, cuda_mpc, dynamics
from dart_planner_tpu_torch.planning import se3_mpc

# the shared memory, in each of the kernel's translation units, and the
# setters of the emulated card's opt-in shared memory and SMs, once
_EMULATION_SMEM = """
namespace { float smem[1 << 22]; }
"""
_EMULATION_GLOBALS = """
#include <cuda_runtime.h>
extern "C" void emu_set_smem_optin(int bytes) { emu_smem_optin = bytes; }
extern "C" void emu_set_sm_count(int sms) { emu_sm_count = sms; }
"""


def build_emulated_library(out: pathlib.Path) -> ctypes.CDLL:
    """Compile the emulated kernel into ``out`` and bind it; skips the
    calling test where there is no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel's CPU emulation")
    source = _build.SRC_DIR / "mpc_solve.cu"
    text, n = re.subn(r"(\w+<S(?:, Ord)?>)<<<([^>]*)>>>\(", r"emu_launch(\1, \2, ",
                      source.read_text())
    assert n == 1, f"{source}: expected one kernel launch, found {n}"
    (out / "mpc_solve.cu").write_text(text + _EMULATION_SMEM)
    shutil.copy(_build.SRC_DIR / "mpc_solve_steps.cu", out)
    (out / "emulation.cpp").write_text(_EMULATION_GLOBALS)
    subprocess.run([gxx, "-std=c++20", "-O2", "-mfma", "-ffp-contract=fast", "-fPIC",
                    "-shared", f"-I{_build.SRC_DIR / 'emulation'}",
                    "-o", str(out / "libmpc_solve.so"), "-x", "c++",
                    *(str(out / f) for f in ("mpc_solve.cu", "mpc_solve_steps.cu",
                                             "emulation.cpp"))],
                   check=True, capture_output=True, text=True)
    lib = cuda_mpc.bind(ctypes.CDLL(str(out / "libmpc_solve.so")))
    assert lib.mpc_params_size() == ctypes.sizeof(cuda_mpc._Params)
    lib.emu_set_smem_optin.argtypes = [ctypes.c_int]
    lib.emu_set_sm_count.argtypes = [ctypes.c_int]
    return lib


def arrays(rng, batch, n_obs):
    """Starts, velocities, goals and spheres (centre, radius) as float32
    numpy arrays."""
    obs = np.concatenate(
        [rng.normal(0, 4, (batch, n_obs, 3)), rng.uniform(0.3, 1.2, (batch, n_obs, 1))],
        axis=-1,
    ).astype(np.float32)
    p0 = rng.normal(0, 2, (batch, 3)).astype(np.float32) + np.float32([0, 0, 5])
    v0 = rng.normal(0, 1, (batch, 3)).astype(np.float32)
    goal = rng.normal(0, 5, (batch, 3)).astype(np.float32) + np.float32([0, 0, 5])
    return p0, v0, goal, obs


def bench_problem(config, batch, seed):
    """The chip smoke's bench batch on the CPU (4 live spheres a scenario)."""
    p0, v0, goal, obs = arrays(np.random.default_rng(seed), batch, 4)
    return se3_mpc.make_problem(p0, v0, goal, obstacles=obs, config=config, device="cpu")


def emulated_round(library, config, batch=16):
    """One launch of the emulated kernel (through the wrapper's own
    flattening, ``cuda_mpc.run_library``, with no stream) against the plain
    loop on the bench batch: thrusts within 2e-3 (float32 sums in another
    order), positions and velocities within 1e-4 of the exact (float64)
    rollout of its own thrusts, its cost within 1e-5 relative of their
    exact cost."""
    prob = bench_problem(config, batch, config.prediction_horizon)
    u0 = se3_mpc.initialize_thrusts(config, prob)
    k = cuda_mpc.run_library(lambda: library, config, prob, u0, True, None)
    p = se3_mpc.solve_thrusts_plain(config, prob, u0)
    torch.testing.assert_close(k[0], p[0], rtol=0, atol=2e-3)
    # the smallest relative improvement, (cost(u0) - cost(u)) / (1 + |cost(u)|),
    # which decides the converged flags: to 1e-4 of 1 + |improvement|, as far
    # as costs 1e-4 relative apart move it
    torch.testing.assert_close(k[1], p[1], rtol=1e-4, atol=1e-4)
    g = torch.tensor([0.0, 0.0, -config.gravity], dtype=torch.float32).double()
    pos, vel, _ = dynamics.rollout_linear(k[0].double(), prob.p0.double(), prob.v0.double(),
                                          config.dt, config.mass, g)
    torch.testing.assert_close(k[2].double(), pos, rtol=0, atol=1e-4)
    torch.testing.assert_close(k[3].double(), vel, rtol=0, atol=1e-4)
    torch.testing.assert_close(k[4].double(), cuda_mpc.exact_cost(config, prob, k[0]),
                               rtol=1e-5, atol=0)
    return k, p


# Among the draws of inside_spheres(seed=0): a scenario whose CG breaks at
# its first step, three whose CG runs three steps (held by
# check_segment_isolation's rounds at CG-0 to CG-3), and one that fills a
# batch past its first warp
BREAKS, GOES_ON, FILLER = 2, (0, 4, 5), 6


def inside_spheres(config, device, seed=0, batch=8):
    """Vehicles at 3 m inside or beside one sphere each: in a full-curvature
    round the sphere's Hessian is indefinite there, and CG may meet negative
    curvature at once."""
    rng = np.random.default_rng(seed)
    p0 = np.zeros((batch, 3), np.float32) + np.float32([0, 0, 3])
    centre = p0 + rng.normal(0, 0.3, (batch, 3)).astype(np.float32)
    radius = rng.uniform(0.5, 2.0, (batch, 1)).astype(np.float32)
    obs = np.concatenate([centre, radius], -1)[:, None, :]
    v0 = rng.normal(0, 1, (batch, 3)).astype(np.float32)
    goal = (rng.normal(0, 3, (batch, 3)) + [0, 0, 3]).astype(np.float32)
    return se3_mpc.make_problem(p0, v0, goal, obstacles=obs, config=config, device=device)


def check_segment_isolation(solve, device, batch):
    """Kernel B1's packed arm keeps each scenario on its own segment of a
    warp: one full-curvature round at CG-3 of each scenario of
    inside_spheres gives the same outputs bit for bit alone in the first
    warp (its three other segments copies of it) and beside three others
    there, in either order, while one of the four breaks CG at its first
    step (its round is the same at CG-0, CG-1 and CG-3; the others' third
    step changes theirs). Every launch holds ``batch`` scenarios, FILLER
    past the first warp: past one wave of the one-scenario-a-warp arm, so
    that the packed arm takes it. ``solve(config, prob, u0)`` launches the
    kernel."""
    config = se3_mpc.SE3MPCConfig(prediction_horizon=20, max_iterations=1, cg_iterations=3,
                                  tail_iterations=0, gn_warmup_iterations=0)
    prob = inside_spheres(config, device)
    u0 = se3_mpc.initialize_thrusts(config, prob)

    def run(warp, cg=3):
        idx = list(warp) + [FILLER] * (batch - len(warp))
        part = se3_mpc.costs.Problem(*[None if x is None else x[idx] for x in prob])
        out = solve(config._replace(cg_iterations=cg), part, u0[idx])
        return [x[:len(warp)].cpu() for x in out[:5]]

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    # the breaking scenario's round leaves d = 0 at any CG budget, then
    # falls back to steepest descent; the others' rounds take three steps
    alone = {i: run([i] * 4) for i in (BREAKS,) + GOES_ON}
    assert same(run([BREAKS] * 4, 0), run([BREAKS] * 4, 1))
    assert same(run([BREAKS] * 4, 1), alone[BREAKS])
    for i in GOES_ON:
        assert not same(run([i] * 4, 2), alone[i])

    warp = (BREAKS,) + GOES_ON
    for order in (warp, warp[::-1]):
        packed = run(order)
        for row, i in enumerate(order):
            for a, b in zip(packed, alone[i]):
                assert torch.equal(a[row], b[0]), (order, i)


def mixed_spheres(config, batch, seed, device="cpu"):
    """Problems with K = ``config.max_obstacles`` sphere slots, of which 0
    to K are live in each scenario, each count about as often, the live
    slots anywhere among the K (as the closed loop's perceived and sensed
    slots are)."""
    K = config.max_obstacles
    rng = np.random.default_rng(seed)
    p0, v0, goal, obs = arrays(rng, batch, K)
    live = rng.integers(0, K + 1, batch)
    mask = rng.permuted(np.arange(K)[None, :].repeat(batch, 0), axis=1) < live[:, None]
    return se3_mpc.make_problem(p0, v0, goal, obstacles=obs, obstacle_mask=mask,
                                config=config, device=device)


def check_live_order(solve, config, prob, monkeypatch):
    """The order by live spheres in which kernel B1's packed arm takes a
    batch (``cuda_mpc.order_mask``) is invisible to the caller:
    ``solve(config, prob, u0)`` on a batch whose live counts are not
    already in that order gives the same outputs bit for bit as the same
    launch in the order given (``order_mask`` patched to order nothing),
    and a permutation of the batch gives the permuted outputs, the
    projected-gradient norm among them (``solve`` asks for it). Returns the
    ordered launch's outputs."""
    u0 = se3_mpc.initialize_thrusts(config, prob)
    live = prob.obstacle_mask.sum(-1)
    assert not torch.equal(live, live.sort(descending=True, stable=True).values)
    ordered = solve(config, prob, u0)
    with monkeypatch.context() as m:
        m.setattr(cuda_mpc, "order_mask", lambda *args: None)
        given = solve(config, prob, u0)
    assert ordered.grad_norm is not None
    for a, b in zip(ordered, given):
        assert torch.equal(a, b)
    perm = torch.randperm(len(u0), generator=torch.Generator().manual_seed(1)).to(u0.device)
    part = se3_mpc.costs.Problem(*[None if x is None else x[perm] for x in prob])
    for a, b in zip(solve(config, part, u0[perm]), ordered):
        assert torch.equal(a, b[perm])
    return ordered
