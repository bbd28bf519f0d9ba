"""lsap_ms.train: device milliseconds a step of the `lsap_kernel` launches
(the matcher), over the profiled steps; from the profiler."""


def read(ctx):
    seconds, launches = ctx.trace.device_s("lsap_kernel")
    steps = len(ctx.trace.items)
    return seconds * 1e3 / steps if launches and steps else None
