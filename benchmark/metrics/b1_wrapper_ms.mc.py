"""Host-clock ms of kernel B1's wrapper in a closed-loop replan (one launch
a replan): the median of the port's ``b1.wrapper`` span
(``cuda_mpc.run_library``, whole: the flattening copies, the parameters,
the constants, the scratch, the launch, the outputs' shapes; tier 0 of
``common/metrics.py``'s ``span``) over the manager's history less its last
n samples, n the profiled run's ``b1.wrapper`` calls (tier 1)."""

import statistics


def read(ctx):
    if not ctx.get("replans"):
        return None
    from dart_planner_tpu_torch.common import metrics

    m = metrics.get_metrics()
    if not hasattr(m, "span_counts"):
        return None
    h = m.history("b1.wrapper")
    h = h[:len(h) - m.span_counts()["calls"].get("b1.wrapper", 0)]
    return statistics.median(h) if h else None
