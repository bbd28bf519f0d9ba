"""predictor_pad_ms.serve: host milliseconds a request of the program's
`predictor.pad` span (the bucket choice, `pad_to_bucket` and the
repeat-pad), under each `predictor.request` span of the profiled slices
(`ziragroundingdino_torch/utils/predictor.py`)."""

from benchmark.lib.spans import ms_per_root


def read(ctx):
    return ms_per_root("predictor.request", "predictor.pad", stream=False)
