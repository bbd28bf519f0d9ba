"""mfu.train: the model FLOPs of the profiled steps (the forward and the
backward the ZiRa step needs, each image at its training size and real
token count, `benchmark/lib/counts.py::ModelFlops`) over the profiled
slices' wall time times the bf16 peak, in %."""

from benchmark.lib.counts import PEAK_BF16_FLOPS


def read(ctx):
    t = ctx.trace
    if t.window_s <= 0 or not t.items:
        return None
    return 100.0 * ctx.model_flops() / (t.window_s * PEAK_BF16_FLOPS)
