"""predictor_resize_ms.serve: host milliseconds a request of the program's
`predictor.resize` span (the `eval_transform` resize of each image), under
each `predictor.request` span of the profiled slices
(`ziragroundingdino_torch/utils/predictor.py`)."""

from benchmark.lib.spans import ms_per_root


def read(ctx):
    return ms_per_root("predictor.request", "predictor.resize", stream=False)
