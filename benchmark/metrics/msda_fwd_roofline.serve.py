"""msda_fwd_roofline.serve: the MSDA forward kernel's share of its roofline
(`benchmark/lib/counts.py::msda_forward_bound` of every call of the
profiled requests, at the shapes the graph runs them at) over the device
time of the `msda_forward_kernel` launches, in %. Nothing where the
launches and the calls differ by more than 5%."""

from benchmark.lib.counts import msda_forward_bound


def read(ctx):
    seconds, launches = ctx.trace.forward_device_s("msda_forward_kernel")
    bounds = ctx.msda_bounds(msda_forward_bound)
    if not launches or abs(launches - len(bounds)) > 0.05 * len(bounds):
        return None
    # the mean call's bound for each launch the trace holds: a launch whose
    # record the profiler dropped takes its time out as well
    mean = sum(t for t, _ in bounds) / len(bounds)
    return 100.0 * mean * launches / seconds
