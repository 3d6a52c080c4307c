"""The device's idle share over one profiled stretch after the window: 1
minus the union of its kernel, copy and set intervals over the stretch's
host-clock length, by torch.profiler, in %. Left out where the profile's
records of a kernel do not match the program's launch counter over the
same stretch (torch.profiler has lost kernel records)."""


def read(ctx):
    prof = ctx.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    for key, n in prof["launches"].items():
        if prof["records"].get(key, 0) != n:
            return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
