"""idle_share.serve: 1 - the union of the device's activity intervals over
the profiled slices' wall time, in % (`chip_smoke.py::profile_window`'s
arithmetic)."""


def read(ctx):
    t = ctx.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.window_s > 0 else None
