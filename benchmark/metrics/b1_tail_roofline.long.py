"""Kernel B1's share of its roofline in the solve's tail pass: the least
time the card could take for the tail's Newton work over ceil(tail_capacity
B) scenarios (``benchmark/lib/roofline.py::b1_work`` at ``tail_config``)
over the device time of the window's tail launches by CUDA events, in %.
The pass of each launch is read from the program's counter
``b1_launches`` (``benchmark/drivers/replan_long.py``)."""


def read(ctx):
    p = (ctx.get("b1_pass") or {}).get("tail")
    if not p or not p["launches"] or p["device_ms"] <= 0:
        return None
    return 100.0 * p["bound_ms"] / p["device_ms"]
