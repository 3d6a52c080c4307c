"""Spans, kernel times and the device trace of a run, all taken from the
benchmark's side of the calls into the program.

- :class:`Spans`: host-clock spans by name around calls into the program;
  under the profiler each is also a ``record_function`` range, so that the
  device's idle gaps can be named by the span the host was in.
- :class:`KernelEvents`: CUDA events around every launch of a kernel,
  put in by wrapping the program's kernel library (its module's
  ``_library`` function): the kernel's own device time, without the
  wrapper's host work and tensor ops.
- :func:`profile`: one torch.profiler pass: the device's busy time (the
  union of its kernel, copy and set intervals), the top device operations,
  the idle gaps summed by the benchmark span the host was in, and the
  count of each named kernel's records, which the caller holds against the
  program's launch counters (torch.profiler has lost kernel records late
  in a run).
- :class:`Conditions`: the card's name and power limit, the SM clock's
  median over the window (nvidia-smi, every 500 ms) and the host's load.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import subprocess
import sys
import time

import torch


class Spans:
    """Named host-clock spans, kept in memory."""

    def __init__(self):
        self.spans: dict[str, list[float]] = {}
        self.annotate = False

    @contextlib.contextmanager
    def span(self, name: str):
        rf = torch.profiler.record_function(name) if self.annotate else contextlib.nullcontext()
        t0 = time.perf_counter()
        with rf:
            try:
                yield
            finally:
                self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def total(self, name: str) -> float:
        return sum(self.spans.get(name, ()))


class _TimedLibrary:
    """A kernel library whose function ``launch`` is bracketed by two CUDA
    events on the current stream."""

    def __init__(self, lib, launch: str, pairs: list):
        self._lib, self._launch, self._pairs = lib, launch, pairs

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name != self._launch:
            return fn

        def timed(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            err = fn(*args)
            end.record()
            self._pairs.append((start, end))
            return err

        return timed


class KernelEvents:
    """CUDA events around each launch of the kernels it is given."""

    def __init__(self):
        self.pairs: dict[str, list] = {}
        self._restore: list = []
        self.missing: list[str] = []

    def install(self, key: str, module, launch: str) -> bool:
        """Time ``launch`` of ``module``'s library (its ``_library()``).
        Returns False, and notes the hook as missing, where the module has
        no such function."""
        original = getattr(module, "_library", None)
        if original is None:
            self.missing.append(f"{module.__name__}._library")
            return False
        pairs = self.pairs.setdefault(key, [])
        timed = _TimedLibrary(original(), launch, pairs)
        module._library = lambda: timed
        self._restore.append((module, original))
        return True

    def uninstall(self) -> None:
        for module, original in reversed(self._restore):
            module._library = original
        self._restore.clear()

    def mark(self, key: str) -> int:
        return len(self.pairs.get(key, ()))

    def ms(self, key: str, start: int = 0, end: int | None = None) -> list[float]:
        """Device ms of each launch of ``key`` in [start, end)."""
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.pairs.get(key, [])[start:end]]


def _intervals(events):
    return sorted((e.time_range.start, e.time_range.end) for e in events)


def _union(iv):
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile(fn, spans: Spans, kernels: dict) -> dict:
    """Run ``fn()`` once under torch.profiler, the benchmark's spans
    annotated: busy and window seconds, the top device operations, the idle
    gaps by span, and for each ``kernels`` entry (key -> a substring of the
    kernel's name) the number of its records."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    spans.annotate = True
    try:
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        spans.annotate = False
    events = list(prof.events())
    labels = set(spans.spans)
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False) and e.name not in labels]
    host = [e for e in events if e.device_type == DeviceType.CPU and e.name in labels]
    busy_iv = _union(_intervals(device))
    busy_us = sum(e - s for s, e in busy_iv)
    by_name: dict[str, float] = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:10]
    gaps: dict[str, float] = {}
    host_iv = sorted(((e.time_range.start, e.time_range.end, e.name) for e in host),
                     key=lambda x: (x[0], -x[1]))
    for (_, a), (b, _) in zip(busy_iv, busy_iv[1:]):
        name = "outside any span"
        for s, e, n in host_iv:  # the innermost span that holds the gap's start
            if s <= a < e:
                name = n
        gaps[name] = gaps.get(name, 0.0) + (b - a)
    idle = sorted(gaps.items(), key=lambda kv: kv[1], reverse=True)[:10]
    records = {k: sum(1 for e in device if sub in e.name) for k, sub in kernels.items()}
    return {"busy_s": busy_us / 1e6, "window_s": wall,
            "device_ops": [[n, us / 1e6] for n, us in top],
            "idle_gaps": [[n, us / 1e6] for n, us in idle], "records": records}


class Conditions:
    """The card and host conditions of a window, for an earlier line."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.proc = None
        self.out = ""

    def _smi(self, *args, timeout=30):
        return subprocess.run(["nvidia-smi", "-i", str(self.device.index or 0), *args],
                              capture_output=True, text=True, timeout=timeout)

    def __enter__(self):
        if self.device.type == "cuda":
            try:
                self.card = self._smi("--query-gpu=name,power.limit",
                                      "--format=csv,noheader").stdout.strip()
                self.proc = subprocess.Popen(
                    ["nvidia-smi", "-i", str(self.device.index or 0),
                     "--query-gpu=clocks.sm", "--format=csv,noheader,nounits", "-lms", "500"],
                    stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
            except (OSError, subprocess.SubprocessError) as e:
                self.card = f"nvidia-smi failed: {e}"
        else:
            self.card = "cpu"
        return self

    def __exit__(self, *exc):
        if self.proc is not None:
            self.proc.terminate()
            try:
                self.out = self.proc.communicate(timeout=30)[0]
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.out = self.proc.communicate()[0]
        return False

    def line(self) -> str:
        clocks = [float(x) for x in self.out.split() if x.replace(".", "", 1).isdigit()]
        clock = f"{statistics.median(clocks):.0f} MHz ({len(clocks)} readings)" if clocks \
            else "not read"
        load = " ".join(f"{x:.2f}" for x in os.getloadavg())
        return f"conditions: card {self.card}; SM clock median {clock}; host load {load}"


def note(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
