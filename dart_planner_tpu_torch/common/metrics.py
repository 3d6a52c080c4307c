"""Runtime metrics with bounded history (PyTorch counterpart of
:mod:`dart_planner_tpu.common.metrics`).

Named bounded-history samples (5000 cap) and counters, percentile summaries
for the latency gates, a Prometheus text exposition with a ``/metrics``
server, and :func:`device_trace`, a ``torch.profiler`` context that writes a
trace of the host and (where there is a card) the device to ``log_dir``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict, deque
from typing import Dict, Iterator, Optional

import numpy as np

_MAX_SAMPLES = 5000  # the reference's history cap


class MetricsManager:
    """Named bounded-history metric store."""

    def __init__(self, max_samples: int = _MAX_SAMPLES):
        self._samples: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=max_samples)
        )
        self._counters: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    def record(self, name: str, value: float) -> None:
        with self._lock:
            self._samples[name].append(float(value))

    def increment(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counters[name] += by

    @contextlib.contextmanager
    def timer(self, name: str) -> Iterator[None]:
        """Record elapsed milliseconds under ``name``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, (time.perf_counter() - t0) * 1e3)

    def summary(self, name: str) -> Optional[dict]:
        with self._lock:
            vals = np.asarray(self._samples.get(name, ()))
        if vals.size == 0:
            return None
        return {
            "count": int(vals.size),
            "mean": float(vals.mean()),
            "min": float(vals.min()),
            "max": float(vals.max()),
            "p50": float(np.percentile(vals, 50)),
            "p95": float(np.percentile(vals, 95)),
            "p99": float(np.percentile(vals, 99)),
        }

    def all_summaries(self) -> dict:
        names = list(self._samples)
        return {
            "metrics": {n: self.summary(n) for n in names},
            "counters": dict(self._counters),
        }

    def reset(self) -> None:
        with self._lock:
            self._samples.clear()
            self._counters.clear()

    def prometheus_exposition(self, prefix: str = "dart") -> str:
        """Prometheus text-exposition rendering of all metrics.

        The reference ships a Prometheus+Grafana ops stack
        (docker-compose.yml:105-130); this emits the same data the
        homegrown counters hold so any scraper can ingest it — counters
        as ``counter``, sample summaries as ``gauge`` quantiles.
        """

        def sanitize(name: str) -> str:
            return "".join(c if c.isalnum() else "_" for c in name)

        lines = []
        with self._lock:
            counters = dict(self._counters)
            names = list(self._samples)
        for name, value in sorted(counters.items()):
            m = f"{prefix}_{sanitize(name)}_total"
            lines.append(f"# TYPE {m} counter")
            lines.append(f"{m} {value}")
        for name in sorted(names):
            s = self.summary(name)
            if s is None:
                continue
            m = f"{prefix}_{sanitize(name)}"
            lines.append(f"# TYPE {m} gauge")
            for q in ("p50", "p95", "p99"):
                lines.append(f'{m}{{quantile="{q[1:]}"}} {s[q]}')
            lines.append(f"{m}_count {s['count']}")
            lines.append(f"{m}_mean {s['mean']}")
        return "\n".join(lines) + "\n"

    def serve(self, port: int = 9100, host: str = "127.0.0.1"):
        """Serve ``/metrics`` (Prometheus text exposition) on a daemon
        thread; returns the ``ThreadingHTTPServer`` (call ``shutdown()``
        to stop): the scrape target ``deploy/prometheus.yml`` points at."""
        import http.server

        manager = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path not in ("/metrics", "/"):
                    self.send_response(404)
                    self.end_headers()
                    return
                body = manager.prometheus_exposition().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        server = http.server.ThreadingHTTPServer((host, port), Handler)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        return server


_global = MetricsManager()


def get_metrics() -> MetricsManager:
    return _global


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """``torch.profiler`` trace of the enclosed work, written to ``log_dir``
    as a Chrome/TensorBoard trace when the context exits (host ops, and the
    device's kernels and copies when a card is visible)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
