"""Host-clock ms of a fleet replan's ``se3_mpc.solve``, waits at its syncs
included: the median of the port's ``mpc.solve`` span (tier 0 of
``common/metrics.py``'s ``span``, one a replan) over the manager's history
less its last n samples, n the profiled stretch's ``mpc.solve`` calls (tier
1), so that the window's replans and set-up's are read, not the
profiler's."""

import statistics


def read(ctx):
    if not ctx.get("replans"):
        return None
    from dart_planner_tpu_torch.common import metrics

    m = metrics.get_metrics()
    if not hasattr(m, "span_counts"):
        return None
    h = m.history("mpc.solve")
    h = h[:len(h) - m.span_counts()["calls"].get("mpc.solve", 0)]
    return statistics.median(h) if h else None
