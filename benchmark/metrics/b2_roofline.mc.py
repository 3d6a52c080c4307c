"""Kernel B2's share of its roofline: the least time for the tick blocks'
bytes and operations (``benchmark/lib/roofline.py``) over B2's device time
by CUDA events around each launch of the traced window, in %."""


def read(ctx):
    b2 = ctx.get("b2")
    if not b2 or not b2["launches"] or b2["device_ms"] <= 0:
        return None
    return 100.0 * b2["bound_ms"] / b2["device_ms"]
