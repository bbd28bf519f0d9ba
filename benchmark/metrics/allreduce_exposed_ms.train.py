"""allreduce_exposed_ms.train: device milliseconds a step in which a
collective kernel (`nccl...`) ran on rank 0 and no other device operation
did: the collectives' time that the step's compute does not hide,
stragglers' waits included; the union of the collectives' intervals less
its overlap with every other kernel, copy and set, over the profiled
steps (`benchmark/lib/trace.py`). Nothing where no collective ran."""

from benchmark.lib.trace import COLLECTIVE


def read(ctx):
    t = ctx.trace
    ran = any(k.startswith(COLLECTIVE) for k in t.kernel_s)
    steps = len(t.items)
    return t.collective_exposed_s * 1e3 / steps if ran and steps else None
