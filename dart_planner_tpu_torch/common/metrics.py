"""Runtime metrics with bounded history (PyTorch counterpart of
:mod:`dart_planner_tpu.common.metrics`).

Named bounded-history samples (5000 cap) and counters, percentile summaries
for the latency gates, a Prometheus text exposition with a ``/metrics``
server, :class:`span`, the program's stage spans, and :func:`device_trace`, a
``torch.profiler`` context that writes a trace of the host and (where there
is a card) the device to ``log_dir`` and sums up what it saw.

A :class:`span` has two tiers. Tier 0 is always on: the span's host-clock
milliseconds go into the global manager's history under its name, so every
stage has its quantiles in :meth:`MetricsManager.summary` and on
``/metrics``; it makes no tensor, no sync and no profiler range. Tier 1 is
on only while torch's profiler records: the span is then also a
``torch.profiler.record_function`` range on the profiler's timeline, counts
its calls, and counts the host syncs (torch's sync debug mode) made while it
is the innermost open span (:meth:`MetricsManager.span_counts`). The
profiler is the switch; there is no other.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import threading
import time
import warnings
from collections import defaultdict, deque
from typing import Dict, Iterator, Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

_MAX_SAMPLES = 5000  # the reference's history cap
# the text of the warning torch gives at a sync under sync debug mode "warn"
SYNC_MESSAGE = "called a synchronizing CUDA operation"


class MetricsManager:
    """Named bounded-history metric store."""

    def __init__(self, max_samples: int = _MAX_SAMPLES):
        self._samples: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=max_samples)
        )
        self._counters: Dict[str, int] = defaultdict(int)
        # counters with labels: name -> {sorted (label, value) pairs: count}
        self._series: Dict[str, Dict[tuple, int]] = defaultdict(lambda: defaultdict(int))
        self._lock = threading.Lock()
        # tier 1 of the spans, apart from the histories: calls and host
        # syncs by span while the profiler records
        self._span_calls: Dict[str, int] = defaultdict(int)
        self._span_syncs: Dict[str, int] = defaultdict(int)
        self._open = threading.local()  # each thread's stack of traced spans
        self._watch_lock = threading.Lock()
        self._watchers = 0
        self._watch = None  # (catch_warnings, the mode to restore or None)

    def record(self, name: str, value: float) -> None:
        with self._lock:
            self._samples[name].append(float(value))

    def increment(self, name: str, by: int = 1, labels: Optional[dict] = None) -> None:
        """Add ``by`` to the counter ``name``, or, with ``labels`` (label ->
        value), to its series of those labels (:meth:`series`)."""
        with self._lock:
            if labels:
                key = tuple(sorted((k, str(v)) for k, v in labels.items()))
                self._series[name][key] += by
            else:
                self._counters[name] += by

    def series(self, name: str) -> Dict[tuple, int]:
        """The labelled counter ``name``: ``{((label, value), ...): count}``,
        the labels sorted by name. Counts only rise (until :meth:`reset`)."""
        with self._lock:
            return dict(self._series.get(name, {}))

    @contextlib.contextmanager
    def timer(self, name: str) -> Iterator[None]:
        """Record elapsed milliseconds under ``name``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, (time.perf_counter() - t0) * 1e3)

    def history(self, name: str) -> list:
        """The samples held under ``name``, oldest first."""
        with self._lock:
            return list(self._samples.get(name, ()))

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

    def span_counts(self) -> dict:
        """Tier 1 of the spans: ``{"calls": {span: n}, "syncs": {span: n}}``,
        each span's calls and the host syncs made while it was the innermost
        open span, counted only while torch's profiler recorded. They only
        rise (until :meth:`reset`): a reader takes the difference over a
        profiled stretch."""
        with self._lock:
            return {"calls": dict(self._span_calls), "syncs": dict(self._span_syncs)}

    def reset(self) -> None:
        with self._lock:
            self._samples.clear()
            self._counters.clear()
            self._series.clear()
            self._span_calls.clear()
            self._span_syncs.clear()

    # -- tier 1 ---------------------------------------------------------
    def _stack(self) -> list:
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        return stack

    def _enter_traced(self, name: str):
        """Open ``name``'s profiler range; the outermost traced span starts
        watching for syncs. Returns the range."""
        stack = self._stack()
        if not stack:
            self._watch_syncs()
        rf = torch.profiler.record_function(name)
        rf.__enter__()
        stack.append(name)
        with self._lock:
            self._span_calls[name] += 1
        return rf

    def _exit_traced(self, rf) -> None:
        stack = self._stack()
        stack.pop()
        rf.__exit__(None, None, None)
        if not stack:
            self._unwatch_syncs()

    def _watch_syncs(self) -> None:
        """Count torch's sync warnings to the innermost open span: sync
        debug mode "warn" where the mode was off (a mode of "warn" or
        "error" that the process set stays, and its warnings are still
        shown), the warning's filter "always", and the warnings module's
        hook; :meth:`_unwatch_syncs` restores all three."""
        with self._watch_lock:
            self._watchers += 1
            if self._watchers > 1:
                return
            restore = None
            if torch.cuda.is_initialized() and torch.cuda.get_sync_debug_mode() == 0:
                torch.cuda.set_sync_debug_mode("warn")
                restore = 0
            catcher = warnings.catch_warnings()
            catcher.__enter__()
            warnings.filterwarnings("always", message=SYNC_MESSAGE)
            shown = warnings.showwarning
            manager = self

            def on_warning(message, category, filename, lineno, file=None, line=None):
                stack = manager._stack()
                if stack and str(message).startswith(SYNC_MESSAGE):
                    with manager._lock:
                        manager._span_syncs[stack[-1]] += 1
                    if restore is not None:
                        return  # the mode is this watch's own: nothing to show
                shown(message, category, filename, lineno, file, line)

            warnings.showwarning = on_warning
            self._watch = (catcher, restore)

    def _unwatch_syncs(self) -> None:
        with self._watch_lock:
            self._watchers -= 1
            if self._watchers > 0 or self._watch is None:
                return
            catcher, restore = self._watch
            self._watch = None
            catcher.__exit__(None, None, None)
            if restore is not None:
                torch.cuda.set_sync_debug_mode(restore)

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
            series = {name: dict(s) for name, s in self._series.items()}
            names = list(self._samples)
        for name, value in sorted(counters.items()):
            m = f"{prefix}_{sanitize(name)}_total"
            lines.append(f"# TYPE {m} counter")
            lines.append(f"{m} {value}")
        for name, by_labels in sorted(series.items()):
            m = f"{prefix}_{sanitize(name)}_total"
            lines.append(f"# TYPE {m} counter")
            for key, value in sorted(by_labels.items()):
                lines.append(f"{m}{_labels_text(key)} {value}")
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


def _labels_text(key: tuple) -> str:
    """A series' labels as Prometheus writes them: ``{a="x",b="y"}``."""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


_global = MetricsManager()


def get_metrics() -> MetricsManager:
    return _global


class span:
    """``with span("mpc.solve"):`` a stage of the program, on the global
    manager: tier 0 records its host-clock milliseconds under its name;
    while torch's profiler records, tier 1 also opens a
    ``torch.profiler.record_function`` range of that name and counts the
    span's calls and the host syncs made while it is the innermost open
    span. ``@span("mpc.finalize")`` on a function opens a fresh span of
    that name around each call. ``ms`` holds the milliseconds recorded
    when the span closed."""

    __slots__ = ("name", "ms", "_t0", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        self._rf = (_global._enter_traced(self.name)
                    if _autograd_profiler._is_profiler_enabled else None)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.ms = (time.perf_counter_ns() - self._t0) * 1e-6
        if self._rf is not None:
            _global._exit_traced(self._rf)
        _global.record(self.name, self.ms)
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return spanned


class TraceSummary:
    """What :func:`device_trace` saw, filled when its context exits.

    - ``wall_s``: the context's host-clock seconds (to a synchronised card);
    - ``busy_s``, ``busy_share``: the union of the device's kernel, copy
      and set intervals, and its share of ``wall_s`` (None without a card);
    - ``idle_s``: the device's idle gaps between those intervals, summed by
      the innermost program span the host was in at each gap's start
      (``"outside any span"`` where none was open);
    - ``calls``, ``syncs``: each span's calls and host syncs over the
      context (tier 1 of :class:`span`)."""

    def __init__(self):
        self.wall_s = 0.0
        self.busy_s: Optional[float] = None
        self.busy_share: Optional[float] = None
        self.idle_s: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}
        self.syncs: Dict[str, int] = {}

    def as_dict(self) -> dict:
        return {"wall_s": self.wall_s, "busy_s": self.busy_s,
                "busy_share": self.busy_share, "idle_s": dict(self.idle_s),
                "calls": dict(self.calls), "syncs": dict(self.syncs)}

    def _read(self, events) -> None:
        """Fill the device's figures from the profiler's events."""
        from torch.autograd import DeviceType

        names = set(self.calls)
        device, host = [], []
        for e in events:
            annotation = getattr(e, "is_user_annotation", False) or e.name in names
            if e.device_type == DeviceType.CUDA and not annotation:
                device.append((e.time_range.start, e.time_range.end))
            elif e.device_type == DeviceType.CPU and e.name in names:
                host.append((e.time_range.start, e.time_range.end, e.name))
        busy = []
        for s, e in sorted(device):
            if busy and s <= busy[-1][1]:
                busy[-1][1] = max(busy[-1][1], e)
            else:
                busy.append([s, e])
        self.busy_s = sum(e - s for s, e in busy) / 1e6
        self.busy_share = self.busy_s / self.wall_s if self.wall_s > 0 else None
        host.sort(key=lambda h: (h[0], -h[1]))  # an outer span before its inner
        starts = [s for s, _, _ in host]
        idle: Dict[str, float] = {}
        for (_, a), (b, _) in zip(busy, busy[1:]):
            # the open span that started last holds the innermost
            name = "outside any span"
            for i in range(bisect.bisect_right(starts, a) - 1, -1, -1):
                if host[i][1] > a:
                    name = host[i][2]
                    break
            idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
        self.idle_s = dict(sorted(idle.items(), key=lambda kv: kv[1], reverse=True))


def _delta(after: dict, before: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in after.items() if n > before.get(k, 0)}


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[TraceSummary]:
    """``torch.profiler`` trace of the enclosed work, written to ``log_dir``
    as a Chrome/TensorBoard trace when the context exits (host ops, the
    program's spans, and the device's kernels and copies when a card is
    visible). Yields a :class:`TraceSummary`, filled on exit: the device's
    busy share, its idle seconds by the program span the host was in, and
    the syncs by span."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    on_card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    summary = TraceSummary()
    before = _global.span_counts()
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        t0 = time.perf_counter()
        yield summary
        if on_card:
            torch.cuda.synchronize()
        summary.wall_s = time.perf_counter() - t0
    after = _global.span_counts()
    summary.calls = _delta(after["calls"], before["calls"])
    summary.syncs = _delta(after["syncs"], before["syncs"])
    if on_card:
        summary._read(prof.events())
