"""allreduce_ms.train: device milliseconds a step of every collective
kernel (names starting `nccl`: DDP's gradient buckets, the criterion's and
the branches' global sums, the losses' mean) over the profiled steps of
rank 0; from the profiler. An NCCL kernel's time includes its wait for the
slowest rank. Nothing where no collective ran."""

from benchmark.lib.trace import COLLECTIVE


def read(ctx):
    t = ctx.trace
    seconds = sum(v for k, v in t.kernel_s.items() if k.startswith(COLLECTIVE))
    steps = len(t.items)
    return seconds * 1e3 / steps if seconds > 0 and steps else None
