"""token_fill.serve: the share of the padded text positions (batch bucket x
text bucket) that hold a real token of a request's caption, summed over the
profiled requests' `predictor.request` spans' counts `tokens_real` and
`tokens_padded`, in %."""

from benchmark.lib.spans import fill


def read(ctx):
    return fill("tokens_real", "tokens_padded")
