"""Weak-scaling efficiency of the PyTorch port's fleet across real processes
(the port's counterpart of scripts/measure_scaling.py, which imports JAX
and stays).

Starts ``python -m dart_planner_tpu_torch.parallel.worker --measure`` at 1,
2, 4 ... processes (up to ``--max-procs``) with a FIXED per-device scenario
load and prints solves/s, solves/s per device and the efficiency,
rate_per_device(N) / rate_per_device(1), as the JAX script's table.

- On the cards (the default): NCCL, one card a process, so process i
  solves on card i through kernel B1. A row with more processes than
  visible cards is refused with a printed reason (two processes cannot
  share a card's NCCL rank); it never becomes gloo.
- ``--device cpu``: the JAX script's CPU rows, gloo with one CPU device a
  process; ``--pin-cores`` pins process i to core i with ``taskset``.

The rate is the worker's own (``distributed.measure_throughput``): the best
of three passes of ``--reps`` chained fleet solves on the host clock after
a synchronize of the process's card, printed beside the card's name and
power limit as nvidia-smi gives them.

    python scripts/measure_scaling_torch.py                     # the cards
    python scripts/measure_scaling_torch.py --per-device 4096 --max-procs 1
    python scripts/measure_scaling_torch.py --device cpu --pin-cores

Without a card it exits non-zero unless ``--device cpu`` is given. Imports
the port only.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from dart_planner_tpu_torch.common.device import card_label  # noqa: E402

WORKER = "dart_planner_tpu_torch.parallel.worker"
WORKER_TIMEOUT_S = 900


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_mesh(num_processes: int, local_devices: int, per_device: int, reps: int,
             pin_cores: bool = False, tail_iterations: int = 0, backend: str = "nccl") -> dict:
    """Start the worker ``num_processes`` times with ``per_device`` scenarios
    on each of its ``local_devices`` devices; return process 0's RESULT
    (its ``throughput`` holds the rates). Every process is stopped before
    this returns or raises."""
    batch = per_device * num_processes * local_devices
    port = free_port()
    ncores = os.cpu_count() or 1

    def prefix(i):
        # one core a process: unpinned, a 1-process run's intra-op threads
        # use every core and under-report the multi-process efficiency
        return ["taskset", "-c", str(i % ncores)] if pin_cores else []

    procs = [
        subprocess.Popen(
            [*prefix(i), sys.executable, "-m", WORKER,
             "--coordinator", f"localhost:{port}",
             "--num-processes", str(num_processes), "--process-id", str(i),
             "--backend", backend, "--local-devices", str(local_devices),
             "--global-batch", str(batch), "--measure", "--reps", str(reps),
             "--tail-iterations", str(tail_iterations)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT,
        )
        for i in range(num_processes)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"worker {i} failed:\n{o[-3000:]}")
    for line in outs[0].splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(outs[0][-2000:])


def table(rows: list) -> list:
    """The JAX script's markdown table of ``rows`` (throughput dicts)."""
    base = rows[0]["solves_per_s_per_device"]
    lines = ["| processes | devices | global batch | solves/s | solves/s/device | efficiency |",
             "|---|---|---|---|---|---|"]
    for t in rows:
        eff = t["solves_per_s_per_device"] / base
        lines.append(f"| {t['processes']} | {t['devices']} | {t['global_batch']} "
                     f"| {t['solves_per_s']:.0f} | {t['solves_per_s_per_device']:.0f} "
                     f"| {eff:.1%} |")
    return lines


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: NCCL, one card a process (default); cpu: gloo")
    ap.add_argument("--per-device", type=int, default=256)
    ap.add_argument("--max-procs", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--pin-cores", action="store_true")
    ap.add_argument("--tail-iterations", type=int, default=0,
                    help="measure with the two-phase adaptive tail (the shipping config is 8)")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            ap.error("no CUDA device: pass --device cpu for gloo rows on the CPU")
        backend, cards = "nccl", torch.cuda.device_count()
        label = f"{card_label('cuda')}, host clock"
    else:
        backend, cards, label = "gloo", None, card_label("cpu")
    print(f"backend={backend} per-device={args.per_device} ({label})", flush=True)

    rows = []
    n = 1
    while n <= args.max_procs:
        if cards is not None and n > cards:
            print(f"procs={n:2d} refused: {cards} visible card(s), and each NCCL process "
                  "needs a card of its own", flush=True)
            break
        t = run_mesh(n, 1, args.per_device, args.reps, pin_cores=args.pin_cores,
                     tail_iterations=args.tail_iterations, backend=backend)["throughput"]
        rows.append(t)
        print(f"procs={n:2d} devices={t['devices']:2d} batch={t['global_batch']:5d} "
              f"solves/s={t['solves_per_s']:6.0f} per-device={t['solves_per_s_per_device']:6.0f}"
              f" ({label})", flush=True)
        n *= 2

    print()
    for line in table(rows):
        print(line)
    return rows


if __name__ == "__main__":
    main()
