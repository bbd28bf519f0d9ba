"""pixel_fill.serve: the share of the padded pixels (batch bucket x image
bucket) that hold a real pixel (each image at its resized size), summed over
the profiled requests' `predictor.request` spans' counts `pixels_real` and
`pixels_padded`, in %."""

from benchmark.lib.spans import fill


def read(ctx):
    return fill("pixels_real", "pixels_padded")
