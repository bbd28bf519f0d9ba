"""optim_ms.train: milliseconds of `Optimizer.step` on the card's stream
(clip, AdamW, schedule), the mean over the traced run's steps; CUDA events
around the method, wrapped on the instance."""


def read(ctx):
    ms = ctx.extra.get("optim_ms")
    return sum(ms) / len(ms) if ms else None
