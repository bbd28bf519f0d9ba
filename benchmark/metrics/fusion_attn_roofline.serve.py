"""fusion_attn_roofline.serve: the fusion attention kernels' share of their
roofline (`benchmark/lib/fusion.py::fusion_attn_bound` of every fusion call
of the profiled requests, at the shapes the graph runs them at) over the
device time of every launch of the family (`fusion_attn_kernel`, both
passes, and `fusion_attn_combine`), in %. Nothing where the launches, three
a call, and the calls differ by more than 5%, and nothing from a program
without the kernels."""

from benchmark.lib.fusion import (KERNELS, LAUNCHES_PER_CALL, fusion_attn_bound, fusion_calls,
                                  fusion_shape)


def read(ctx):
    calls = fusion_calls(ctx)
    seconds, launches = ctx.trace.device_s(KERNELS)
    if not calls or not launches or seconds <= 0:
        return None
    made = launches / LAUNCHES_PER_CALL
    if abs(made - len(calls)) > 0.05 * len(calls):
        return None
    heads, hd = fusion_shape(ctx.conf)
    # the mean call's bound for each call the launches make: a launch whose
    # record the profiler dropped takes its time out as well
    mean = sum(fusion_attn_bound(b, nv, nl, heads, hd)[0] for b, nv, nl in calls) / len(calls)
    return 100.0 * mean * made / seconds
