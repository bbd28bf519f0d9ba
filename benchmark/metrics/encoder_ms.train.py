"""encoder_ms.train: stream milliseconds a step of every call of the
encoder's layer modules (fusion, text and deformable layers; in the forward
and again where remat recomputes them in the backward); CUDA events from
forward hooks, sound in eager only."""


def read(ctx):
    ms = ctx.extra.get("encoder_ms")
    return ms[0] if ms else None
