"""The yardstick's counts against hand counts and direct counts at tiny
shapes."""

import math

import pytest
import torch

from benchmark.lib import counts
from benchmark.tests.tiny import tiny_config


def test_level_shapes():
    # the port's encoder token counts at the serving buckets (20197 at 800x1216)
    assert sum(h * w for h, w in counts.level_shapes(800, 1216)) == 20197
    assert counts.level_shapes(800, 1344) == [(100, 168), (50, 84), (25, 42), (13, 21)]
    assert counts.level_shapes(36, 44) == [(5, 6), (3, 3), (2, 2), (1, 1)]


def test_msda_bounds_by_hand():
    b, q, s, h, d, lv, p = 1, 10, 20, 2, 4, 3, 2
    samples = b * q * h * lv * p
    nbytes = b * s * h * d * 2 + samples * 8 + samples * 4 + b * q * h * d * 2
    t, got = counts.msda_forward_bound(b, q, s, h, d, lv, p)
    assert got == nbytes
    assert t == max(nbytes / counts.HBM_BYTES_PER_S, samples * (8 * d + 20) / counts.F32_FLOPS)
    t, got = counts.msda_backward_bound(b, q, s, h, d, lv, p)
    assert got == nbytes + b * s * h * d * 2 + 4 * samples * 3
    assert t == max(got / counts.HBM_BYTES_PER_S, samples * (16 * d + 40) / counts.F32_FLOPS)


def test_counter_counts_a_linear_by_hand():
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference.model import Linear

    with torch.device("meta"):
        lin = Linear(16, 24)
        x = torch.empty(5, 7, 16)
    with FlopCounterMode(display=False) as fc:
        lin(x)
    assert fc.get_total_flops() == 2 * 5 * 7 * 16 * 24


@pytest.fixture(scope="module", params=[False, True], ids=["serve", "train"])
def flops(request):
    return counts.ModelFlops(tiny_config(), train=request.param)


@pytest.mark.parametrize("h,w,t", [(96, 128, 7), (120, 160, 21), (64, 200, 40)])
def test_decomposition_matches_direct_counts(flops, h, w, t):
    assert flops(h, w, t) == flops.direct(4 * math.ceil(h / 4), 4 * math.ceil(w / 4), t)


def test_train_counts_more_than_serve():
    conf = tiny_config()
    serve = counts.ModelFlops(conf, train=False).direct(96, 128, 11)
    train = counts.ModelFlops(conf, train=True).direct(96, 128, 11)
    # the backward reaches the encoder and decoder, not Swin or BERT
    assert serve < train < 3 * serve
