"""Kernel B1's share of its roofline in the solve's first pass: the least
time the card could take for phase 1's Newton work over all B scenarios
(``benchmark/lib/roofline.py::b1_work`` at the configuration) over the
device time of the window's phase-1 launches by CUDA events, in %. The
pass of each launch is read from the program's counter ``b1_launches``
(``benchmark/drivers/replan_long.py``)."""


def read(ctx):
    p = (ctx.get("b1_pass") or {}).get("phase1")
    if not p or not p["launches"] or p["device_ms"] <= 0:
        return None
    return 100.0 * p["bound_ms"] / p["device_ms"]
