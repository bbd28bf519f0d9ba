"""msda_bwd_roofline.train: the MSDA backward's share of its roofline
(`benchmark/lib/counts.py::msda_backward_bound` of every backward call of
the profiled steps) over the device time of every kernel, copy and set
launched under the `_MSDAFunctionBackward` autograd nodes (bins, main
pass, accumulate, memsets, casts), in %."""

from benchmark.lib.counts import msda_backward_bound


def read(ctx):
    seconds = ctx.trace.msda_bwd_s
    bounds = ctx.msda_bounds(msda_backward_bound)
    if seconds <= 0 or not bounds:
        return None
    return 100.0 * sum(t for t, _ in bounds) / seconds
