"""Host syncs a closed-loop replan makes inside the program: the syncs
counted inside the port's spans (tier 1 of ``common/metrics.py``'s
``span``, by torch's sync debug mode while the profiler records) over the
profiled run after the window, over that run's ``loop.replan`` calls:
sum(syncs by span) / calls["loop.replan"], in syncs a replan (the run's
``loop.prepare`` and ``loop.outcome`` included)."""


def read(ctx):
    if not ctx.get("replans") or not ctx.get("profile"):
        return None
    from dart_planner_tpu_torch.common import metrics

    counts = getattr(metrics.get_metrics(), "span_counts", None)
    if counts is None:
        return None
    counts = counts()
    replans = counts["calls"].get("loop.replan", 0)
    return sum(counts["syncs"].values()) / replans if replans else None
