"""Host syncs a fleet replan makes inside the program: the syncs counted
inside the port's spans (tier 1 of ``common/metrics.py``'s ``span``, by
torch's sync debug mode while the profiler records) over the profiled
stretch after the window, over that stretch's ``mpc.solve`` calls (one a
replan): sum(syncs by span) / calls["mpc.solve"], in syncs a replan."""


def read(ctx):
    if not ctx.get("replans") or not ctx.get("profile"):
        return None
    from dart_planner_tpu_torch.common import metrics

    counts = getattr(metrics.get_metrics(), "span_counts", None)
    if counts is None:
        return None
    counts = counts()
    solves = counts["calls"].get("mpc.solve", 0)
    return sum(counts["syncs"].values()) / solves if solves else None
