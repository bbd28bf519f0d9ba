"""criterion_ms.train: stream milliseconds a step of the program's
`step.criterion` span (class logits, `set_criterion` with its matcher, the
ZiRa losses), under each `step` span of the profiled slices
(`ziragroundingdino_torch/train/step.py`); CUDA events on the step's stream."""

from benchmark.lib.spans import ms_per_root


def read(ctx):
    return ms_per_root("step", "step.criterion", stream=True)
