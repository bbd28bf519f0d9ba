"""predictor_tokenize_ms.serve: host milliseconds a request of the program's
`predictor.tokenize` span (the captions and `tokenize_captions`), under each
`predictor.request` span of the profiled slices
(`ziragroundingdino_torch/utils/predictor.py`)."""

from benchmark.lib.spans import ms_per_root


def read(ctx):
    return ms_per_root("predictor.request", "predictor.tokenize", stream=False)
