"""predictor_prep_ms.serve: host milliseconds from a `Predictor.__call__`'s
start to its `cudaGraphLaunch` (eval resize, tokenisation, staging), the
mean over the profiled requests; from the profiler's host events inside the
benchmark's `record_function` range around each call."""


def read(ctx):
    ms = ctx.trace.prep_ms
    return sum(ms) / len(ms) if ms else None
