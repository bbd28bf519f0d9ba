"""predictor_stage_ms.serve: host milliseconds a request of the program's
`predictor.stage` span (the copies into pinned staging and the
host-to-device enqueue), under each `predictor.request` span of the profiled
slices (`ziragroundingdino_torch/utils/predictor.py`)."""

from benchmark.lib.spans import ms_per_root


def read(ctx):
    return ms_per_root("predictor.request", "predictor.stage", stream=False)
