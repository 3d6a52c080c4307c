"""Kernel B1's share of its roofline: the least time the card could take
for the solves' Newton work (``benchmark/lib/roofline.py``, reckoned from
the configuration and the problems' shapes) over B1's device time by CUDA
events around each launch of the traced window, in %."""


def read(ctx):
    b1 = ctx.get("b1")
    if not b1 or not b1["launches"] or b1["device_ms"] <= 0:
        return None
    return 100.0 * b1["bound_ms"] / b1["device_ms"]
