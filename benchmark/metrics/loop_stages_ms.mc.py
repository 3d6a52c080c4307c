"""Host-clock ms a closed-loop replan spends in the loop's own stages, from
the port's spans (tier 0 of ``common/metrics.py``'s ``span``): the sum of
the medians of the per-replan stages ``loop.speed_cap``, ``loop.margins``,
``loop.sensing``, ``loop.problem`` and ``b2.setpoints``, plus (the median
of ``loop.prepare`` + the median of ``loop.outcome``) / the replans of a
run; each median over the manager's history less its last n samples, n
the profiled run's calls of that span (tier 1). The inside counterpart of
``loop_host_ms.mc``; a stage the configuration does not run adds 0."""

import statistics

PER_REPLAN = ("loop.speed_cap", "loop.margins", "loop.sensing", "loop.problem",
              "b2.setpoints")
PER_RUN = ("loop.prepare", "loop.outcome")


def read(ctx):
    if not ctx.get("replans") or not ctx.get("runs"):
        return None
    from dart_planner_tpu_torch.common import metrics

    m = metrics.get_metrics()
    if not hasattr(m, "span_counts"):
        return None
    traced = m.span_counts()["calls"]

    def median(name):
        h = m.history(name)
        h = h[:len(h) - traced.get(name, 0)]
        return statistics.median(h) if h else None

    per_replan = [median(n) for n in PER_REPLAN]
    per_run = [median(n) for n in PER_RUN]
    if all(v is None for v in per_replan + per_run):
        return None
    replans_a_run = ctx["replans"] / ctx["runs"]
    return (sum(v for v in per_replan if v is not None)
            + sum(v for v in per_run if v is not None) / replans_a_run)
