"""run_decoder_ms.serve: stream milliseconds a request of the program's
`predictor.run.decoder` span (query selection, the decoder, the heads and the
post-processing): a part of the key's replayed graph, timed by events captured
into it, under each request's `predictor.run` span in the profiled slices
(`ziragroundingdino_torch/utils/predictor.py::PARTS`). Nothing from a program
whose graphs hold no such events."""

from benchmark.lib.spans import ms_per_root


def read(ctx):
    return ms_per_root("predictor.run", "predictor.run.decoder", stream=True)
