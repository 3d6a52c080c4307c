"""Driver of a fleet shard at a long horizon: :mod:`replan`'s closed loop,
unchanged, with kernel B1's device time split by the pass of the solve
that launched it, for the per-pass roofline shares.

The pass of each launch comes from the program's counter ``b1_launches``
(``common/metrics.py``, labelled by ``pass``, ``steps`` and ``arena``): the
launches are timed by CUDA events as in :mod:`replan`, and at each launch
the counter's series that rose since the last one names the pass of the
launch before it. A program without the counter leaves the split out (the
readers find nothing). In a traced run the arms B1 launched in the window
are noted on standard error.
"""

from __future__ import annotations

import math

from benchmark.drivers import replan
from benchmark.lib import roofline
from benchmark.lib.trace import note


class _PassLog:
    """The pass of each B1 launch through a library, read from the
    counter's rises between launches."""

    def __init__(self, manager, library):
        self._manager, self._lib = manager, library
        self._last = manager.series("b1_launches")
        self._open = False  # a launch whose pass is not read yet
        self.passes: list = []

    def settle(self) -> None:
        """Give the last launch its pass: the series that rose since the
        last snapshot (None where none or several rose)."""
        now = self._manager.series("b1_launches")
        if self._open:
            rose = [dict(k) for k, n in now.items() if n > self._last.get(k, 0)]
            self.passes.append(rose[0] if len(rose) == 1 else None)
            self._open = False
        self._last = now

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name != "mpc_solve_launch":
            return fn

        def launch(*args):
            self.settle()
            err = fn(*args)
            self._open = True
            return err

        return launch


class Cell(replan.Cell):
    def setup(self) -> None:
        super().setup()
        self.log, self.log_from = None, 0
        if self.events is None:
            return
        from dart_planner_tpu_torch.common import metrics
        from dart_planner_tpu_torch.ops import cuda_mpc

        manager = metrics.get_metrics()
        if not hasattr(manager, "series"):
            return
        # above the events' wrapper, which its uninstall removes with this
        timed = cuda_mpc._library()
        self.log = _PassLog(manager, timed)
        self.log_from = self.events.mark("B1")
        cuda_mpc._library = lambda: self.log

    def layers(self) -> dict:
        """:mod:`replan`'s ingredients, and B1's device ms, launches and
        bound of each pass over the window (``b1_pass``)."""
        ctx = super().layers()
        if self.log is None:
            return ctx
        self.log.settle()
        ms = self.events.ms("B1", self.b1_mark)
        labels = self.log.passes[self.b1_mark - self.log_from:]
        if len(labels) != len(ms):
            note(f"trace: {len(labels)} passes read for {len(ms)} B1 launches: "
                 "the per-pass shares are left out")
            return ctx
        live, slots = self.inp["obstacles"].shape[1], self.cfg.max_obstacles
        C = max(1, math.ceil(self.ref_cfg.tail_capacity * self.B))
        bound = {"phase1": roofline.bound_ms(*roofline.b1_work(
                     self.ref_cfg, self.B, live, slots, False))[0],
                 "tail": roofline.bound_ms(*roofline.b1_work(
                     roofline.tail_config(self.ref_cfg), C, live, slots, False))[0]}
        by_pass, arms = {}, {}
        for t, lab in zip(ms, labels):
            arm = "unread" if lab is None else (
                f"{lab['pass']} steps={lab['steps']} arena={lab['arena']}")
            arms[arm] = arms.get(arm, 0) + 1
            if lab is None or lab["pass"] not in bound:
                continue
            p = by_pass.setdefault(lab["pass"], {"device_ms": 0.0, "launches": 0,
                                                 "bound_ms": 0.0})
            p["device_ms"] += t
            p["launches"] += 1
            p["bound_ms"] += bound[lab["pass"]]
        note("b1 arms in the window: " + "; ".join(
            f"{arm} x {n} ({n / max(1, len(self.walls)):.2f} a replan)"
            for arm, n in sorted(arms.items())))
        for name, p in sorted(by_pass.items()):
            note(f"b1 {name}: {p['device_ms'] / p['launches']:.4f} ms a launch by CUDA events, "
                 f"bound {p['bound_ms'] / p['launches']:.4f} ms")
        ctx["b1_pass"] = by_pass
        return ctx
