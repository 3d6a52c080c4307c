#!/usr/bin/env python3
"""Reproduce ROADMAP C.23: the cold start's inverse in a process after it
forked a ``ProcessControlLoop``.

    python3 scripts/fork_lapack_hang.py                # CUDA started first
    python3 scripts/fork_lapack_hang.py --device cpu   # without a card

A fresh Python process, under a watchdog (``--timeout`` seconds, then its
process group is killed), starts CUDA (a tensor on the card, unless
``--device cpu``), warms numpy's OpenBLAS thread pool with a 100 x 100
float64 inverse and product, as the cold starts of earlier horizons do,
starts ``runtime.multiprocess_loop.ProcessControlLoop`` (a fork of that
process, the default context), feeds it one state, stops it, and then takes
``planning.se3_mpc._quadratic_hessian_inverse`` at N=100 from an empty
cache, by whatever route the checkout's package takes (``np.linalg.inv``
before the repair). Prints ``ok`` with its seconds, or ``HUNG`` with the
stack the watchdog dumped and exits 1. Imports the PyTorch port only.
"""

from __future__ import annotations

import argparse
import faulthandler
import os
import pathlib
import signal
import subprocess
import sys
import time

N = 100


def child(device: str, timeout: float) -> None:
    """The order in this process; the watchdog's stack dump lands on stderr
    shortly before the parent kills the process group."""
    faulthandler.dump_traceback_later(max(timeout - 5.0, 1.0), exit=False)
    import numpy as np
    import torch

    from dart_planner_tpu_torch.planning import se3_mpc
    from dart_planner_tpu_torch.runtime.multiprocess_loop import ProcessControlLoop

    if device == "cuda":
        x = torch.ones(1024, device="cuda")
        torch.cuda.synchronize()
        assert float(x.sum()) == 1024.0
    a = np.random.default_rng(0).normal(size=(N, N))
    np.linalg.inv(a @ a.T + N * np.eye(N))  # the thread pool is up before the fork
    loop = ProcessControlLoop(_speed, frequency_hz=50.0)
    loop.start()
    loop.send_state({"velocity": np.ones(3)})
    deadline = time.perf_counter() + 1.0
    while loop.get_output(timeout=0.05) is None and time.perf_counter() < deadline:
        pass
    loop.stop()

    t0 = time.perf_counter()
    se3_mpc._quadratic_hessian_inverse.cache_clear()
    out = se3_mpc._quadratic_hessian_inverse(se3_mpc.SE3MPCConfig(prediction_horizon=N))
    faulthandler.cancel_dump_traceback_later()
    assert np.isfinite(out).all()
    print(f"{time.perf_counter() - t0:.4f}", flush=True)


def _speed(state):
    import numpy as np

    return float(np.linalg.norm(state["velocity"]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="start CUDA before the fork (default) or not")
    ap.add_argument("--timeout", type=float, default=90.0,
                    help="seconds the child may take, the fork included")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.device, args.timeout)
        return 0
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("no CUDA device: pass --device cpu to run without one", file=sys.stderr)
            return 2
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    proc = subprocess.Popen(
        [sys.executable, __file__, "--child", "--device", args.device,
         "--timeout", str(args.timeout)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        start_new_session=True)
    t0 = time.perf_counter()
    try:
        out, err = proc.communicate(timeout=args.timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        stack = " | ".join(ln.strip() for ln in err.splitlines() if ln.strip().startswith("File"))
        print(f"[C.23 {args.device}] cold start: HUNG (killed after "
              f"{time.perf_counter() - t0:.1f} s); stack: {stack[-1500:]}", flush=True)
        return 1
    if proc.returncode != 0:
        raise RuntimeError(f"exit {proc.returncode}: {err[-2000:]}")
    print(f"[C.23 {args.device}] cold start: ok, the inverse at N={N} took "
          f"{float(out.split()[-1]):.4f} s after the fork", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
