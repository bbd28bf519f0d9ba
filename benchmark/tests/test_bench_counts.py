"""The yardstick's counts against hand counts and direct counts at tiny
shapes."""

import json
import math
from pathlib import Path

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


# ---------------------------------------------------------------- level layouts
BEFORE = json.loads((Path(__file__).parent / "data" / "counts_4_levels.json").read_text())
BENCH = Path(__file__).resolve().parents[1]
TRAFFICS = ("serve-odinw", "serve-coco", "train-b8")


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def buckets():
    out = set()
    for t in TRAFFICS:
        mix = json.loads((BENCH / "traffic" / f"{t}.json").read_text())
        out |= {tuple(b) for b in mix.get("shape_buckets", mix.get("data", {}).get(
            "shape_buckets", []))}
    return sorted(out)


@pytest.mark.parametrize("name", ["zira-t", "gdino-b"])
def test_four_level_shapes_as_before(name):
    conf = config(name)
    for h, w in buckets():
        assert [list(s) for s in counts.conf_level_shapes(conf, h, w)] == \
            BEFORE["level_shapes"][f"{h}x{w}"]


@pytest.mark.parametrize("name,train", [("zira-t", False), ("zira-t", True), ("gdino-b", False)])
def test_four_level_model_flops_as_before(name, train):
    mf = counts.ModelFlops(config(name), train=train)
    keys = [k for k in BEFORE["flops"] if k.startswith(f"{name}.{int(train)}.")]
    assert keys
    for k in keys:
        hw, t = k.split(".")[2:]
        h, w = map(int, hw.split("x"))
        assert mf(h, w, int(t)) == BEFORE["flops"][k], k


class _Trace:
    def __init__(self, items):
        self.items = items


class _Run:
    def __init__(self, shapes):
        self.shapes = shapes

    def device_shape(self, item):
        return self.shapes[item]


@pytest.mark.parametrize("name", ["zira-t", "gdino-b"])
def test_four_level_msda_calls_as_before(name):
    from benchmark.run import LayerContext

    conf = config(name)
    m = conf["model"]
    shapes = [(2, h, w) for h, w in buckets()]
    ctx = LayerContext("serve", _Trace(list(range(len(shapes)))), _Run(shapes), conf, {})
    want = []
    for b, h, w in shapes:
        s = sum(hh * ww for hh, ww in BEFORE["level_shapes"][f"{h}x{w}"])
        want += [(b, s, s)] * m["enc_layers"] + [(b, m["num_queries"], s)] * m["dec_layers"]
    assert ctx.msda_calls() == want
    assert [t for t, _ in ctx.msda_bounds(counts.msda_forward_bound)] == \
        [counts.msda_forward_bound(b, q, s)[0] for b, q, s in want]


def five_levels():
    """The tiny configuration with MM-Grounding-DINO-L's level layout: Swin's
    four stages (strides 4-32) and one extra conv level."""
    conf = tiny_config()
    conf["swin"]["out_indices"] = [0, 1, 2, 3]
    conf["model"]["return_interm_indices"] = [0, 1, 2, 3]
    conf["model"]["num_feature_levels"] = 5
    return conf


@pytest.mark.parametrize("h,w", [(96, 128), (100, 164)])
def test_five_level_shapes_are_the_reference_model(h, w):
    from benchmark.reference.model import GroundingDINO, RefConfig

    conf = five_levels()
    with torch.device("meta"):
        model = GroundingDINO(RefConfig.from_file(conf)).configure(msda_chunk=1 << 40)
        px = torch.empty(1, h, w, 3)
        mask = torch.ones(1, h, w, dtype=torch.bool)
        text = {"input_ids": torch.zeros(1, 5, dtype=torch.long),
                "text_token_mask": torch.ones(1, 5, dtype=torch.bool),
                "position_ids": torch.zeros(1, 5, dtype=torch.long),
                "text_self_attention_masks": torch.ones(1, 5, 5, dtype=torch.bool)}
        out = model.eval()(px, mask, text)
    got = [tuple(int(x) for x in s) for s in out["shapes"]]
    assert len(got) == 5
    assert got == counts.conf_level_shapes(conf, h, w)


@pytest.fixture(scope="module", params=[False, True], ids=["serve", "train"])
def five_level_flops(request):
    return counts.ModelFlops(five_levels(), train=request.param)


@pytest.mark.parametrize("h,w,t", [(96, 128, 7), (120, 164, 21)])
def test_five_level_flops_match_direct_counts(five_level_flops, h, w, t):
    assert five_level_flops(h, w, t) == five_level_flops.direct(4 * math.ceil(h / 4),
                                                                4 * math.ceil(w / 4), t)


def test_five_level_msda_bounds_take_the_levels():
    from benchmark.run import LayerContext

    conf = five_levels()
    ctx = LayerContext("train", _Trace([0]), _Run([(2, 96, 128)]), conf, {})
    m = conf["model"]
    s = sum(hh * ww for hh, ww in counts.conf_level_shapes(conf, 96, 128))
    bounds = ctx.msda_bounds(counts.msda_backward_bound)
    assert len(bounds) == m["enc_layers"] + m["dec_layers"]
    assert bounds[0] == counts.msda_backward_bound(2, s, s, m["nheads"],
                                                   m["hidden_dim"] // m["nheads"], 5,
                                                   m["enc_n_points"])
