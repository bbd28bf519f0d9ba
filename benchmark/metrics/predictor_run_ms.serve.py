"""predictor_run_ms.serve: host milliseconds a request of the program's
`predictor.run` span (the graph's replay to its outputs on the host: the
host's wait on the device), under each `predictor.request` span of the
profiled slices (`ziragroundingdino_torch/utils/predictor.py`)."""

from benchmark.lib.spans import ms_per_root


def read(ctx):
    return ms_per_root("predictor.request", "predictor.run", stream=False)
