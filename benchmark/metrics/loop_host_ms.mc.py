"""Host time a closed-loop replan spends outside ``se3_mpc.solve`` and
``cuda_rollout.run_tick_block``: the host-clock spans of whole runs of
``simulate_episode`` minus the spans around those two calls, over the
replans of the traced window, in ms."""


def read(ctx):
    return ctx.get("loop_host_ms")
