"""msda_fwd_roofline.train: the MSDA forward kernel's share of its roofline
in the train step (`benchmark/lib/counts.py::msda_forward_bound` of every
forward call of the profiled steps, at their batch's padded shapes) over
the device time of the `msda_forward_kernel` launches of the forward
passes (remat's recompute, launched from the backward, left out), in %.
Nothing where the launches and the calls differ by more than 5%."""

from benchmark.lib.counts import msda_forward_bound


def read(ctx):
    seconds, launches = ctx.trace.forward_device_s("msda_forward_kernel")
    bounds = ctx.msda_bounds(msda_forward_bound)
    if not launches or abs(launches - len(bounds)) > 0.05 * len(bounds):
        return None
    mean = sum(t for t, _ in bounds) / len(bounds)
    return 100.0 * mean * launches / seconds
