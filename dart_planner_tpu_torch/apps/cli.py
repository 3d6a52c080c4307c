"""Command-line interface (PyTorch counterpart of
:mod:`dart_planner_tpu.apps.cli`): the ``dart-planner-tpu-torch`` script.

    python -m dart_planner_tpu_torch.apps.cli run --mode=cloud [--port 5555]
    python -m dart_planner_tpu_torch.apps.cli run --mode=edge|sim
    python -m dart_planner_tpu_torch.apps.cli demo [--port 8080]
    python -m dart_planner_tpu_torch.apps.cli bench [--seed 0] [--budget-s 480]

Port of the reference ``dart_planner_cli.py`` (:10-43): ``run
--mode=cloud|edge`` dispatch after loading + validating the port's frozen
config, extended with ``sim`` (minimal takeoff) and ``demo`` (the
websocket web demo), and ``bench``, which runs the port's benchmark, the
root ``bench_torch.py`` (as the JAX CLI's ``bench`` runs ``bench.py``), and
exits with its code. Every app runs on ``--device`` (default: the first
CUDA card; without one the CLI raises before anything starts, and never
falls back to the CPU).
"""

from __future__ import annotations

import argparse
import asyncio
import os
import sys

from dart_planner_tpu_torch.common.device import resolve_device


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="dart-planner-tpu-torch",
        description="SE(3) MPC drone autonomy stack on PyTorch and CUDA",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    run_p = sub.add_parser("run", help="run a stack component")
    run_p.add_argument(
        "--mode",
        choices=["cloud", "edge", "sim"],
        required=True,
        help="cloud: three-layer planning service; edge: control loop; "
        "sim: minimal takeoff demo",
    )
    run_p.add_argument("--port", type=int, default=5555)
    run_p.add_argument("--duration", type=float, default=None)

    demo_p = sub.add_parser("demo", help="run the websocket web demo")
    demo_p.add_argument("--port", type=int, default=8080)
    demo_p.add_argument("--duration", type=float, default=None)

    bench_p = sub.add_parser("bench", help="run the port's benchmark (bench_torch.py)")
    bench_p.add_argument("--seed", type=int, default=0)
    bench_p.add_argument("--budget-s", type=float, default=480.0)
    for p in (run_p, demo_p, bench_p):
        p.add_argument(
            "--device",
            default=None,
            help="torch device the app runs on (default: the first CUDA "
            "card; 'cpu' for the CPU)",
        )

    args = parser.parse_args(argv)

    # load + validate frozen config before anything runs (reference :25-32)
    from dart_planner_tpu_torch.config import get_frozen_config

    get_frozen_config()
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise RuntimeError(f"{e} (on the command line: --device cpu)") from e

    # optional ops endpoint for ANY mode: DART_METRICS_PORT serves the
    # Prometheus exposition the deploy/ stack scrapes (deploy/README.md)
    metrics_server = None
    if os.environ.get("DART_METRICS_PORT") and args.command != "demo":
        # (the demo starts its own endpoint from the same env var)
        from dart_planner_tpu_torch.common.metrics import get_metrics

        metrics_server = get_metrics().serve(
            int(os.environ["DART_METRICS_PORT"]),
            host=os.environ.get("DART_METRICS_HOST", "127.0.0.1"),
        )

    try:
        if args.command == "run":
            if args.mode == "cloud":
                from dart_planner_tpu_torch.apps import cloud

                asyncio.run(cloud.main(port=args.port, duration=args.duration,
                                       device=device))
            elif args.mode == "edge":
                from dart_planner_tpu_torch.apps import edge

                stats = asyncio.run(edge.main(duration=args.duration or 10.0,
                                              device=device))
                print(stats)
            else:
                from dart_planner_tpu_torch.apps import minimal_takeoff

                minimal_takeoff.main(device=device)
        elif args.command == "bench":
            import pathlib
            import runpy

            bench = pathlib.Path(__file__).resolve().parents[2] / "bench_torch.py"
            saved_argv = sys.argv
            sys.argv = [str(bench), "--device", str(device), "--seed", str(args.seed),
                        "--budget-s", str(args.budget_s)]
            try:
                runpy.run_path(str(bench), run_name="__main__")  # raises SystemExit
            finally:
                sys.argv = saved_argv
        else:
            from dart_planner_tpu_torch.apps import web_demo

            asyncio.run(web_demo.main(port=args.port, duration=args.duration,
                                      device=device))
    finally:
        if metrics_server is not None:
            metrics_server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
