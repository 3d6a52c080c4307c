"""Host and device time a fleet replan spends outside kernel B1: the mean
replan's host-clock time (start to synchronised plan) minus B1's device
time in a replan, by CUDA events around each launch. The solve's glue:
``make_problem``, the tail's ranking and compaction, ``_finalize``,
``extract_trajectory``, the wrapper's copies."""


def read(ctx):
    b1 = ctx.get("b1")
    if not b1 or not b1["launches"] or not ctx.get("replans"):
        return None
    return ctx["replan_ms"] - b1["device_ms"] / ctx["replans"]
