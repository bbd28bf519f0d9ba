"""The fusion attention's bound and calls, and the reader of
`fusion_attn_roofline.serve` on stand-in traces."""

import types

import pytest

import benchmark.run as bench
from benchmark.lib import counts, fusion
from benchmark.tests.tiny import tiny_config


def test_bound_at_serve_coco():
    """B = 2, Nv = 20197 (800x1216), Nl = 256, 4 heads of 256: ~252 MB and
    ~63.5 GFLOP; bytes bound it, at ~75 us."""
    t, nbytes = fusion.fusion_attn_bound(2, 20197, 256)
    e = 1024
    assert nbytes == 2 * (3 * 2 * 20197 * e + 3 * 2 * 256 * e) + 2 * (20197 + 256)
    assert 250e6 < nbytes < 253e6
    flops = 3 * 2 * 2 * 4 * 20197 * 256 * 256
    assert 63.4e9 < flops < 63.6e9
    assert t == nbytes / counts.HBM_BYTES_PER_S > flops / counts.PEAK_BF16_FLOPS
    assert 74e-6 < t < 76e-6


def test_fusion_shape_of_the_configurations():
    for name in ("zira-t", "gdino-b"):
        conf = tiny_config(name)
        conf["model"] = dict(conf["model"], nheads=8, dim_feedforward=2048)
        assert fusion.fusion_shape(conf) == (4, 256)


class _Trace:
    def __init__(self, items, seconds, launches):
        self.items, self._s, self._n = items, seconds, launches

    def device_s(self, part):
        assert part == fusion.KERNELS
        return self._s, self._n


def _ctx(launches, seconds=1e-3, use_fusion=True):
    conf = tiny_config("zira-t")
    conf["model"] = dict(conf["model"], nheads=8, dim_feedforward=2048, enc_layers=6,
                         use_fusion_layer=use_fusion)
    run = types.SimpleNamespace(key=lambda req: req)
    items = [(2, (800, 1216), 256, 90)] * 4  # four profiled requests: 24 calls
    return types.SimpleNamespace(conf=conf, run=run, trace=_Trace(items, seconds, launches))


@pytest.mark.parametrize("launches,reads", [(72, True), (70, True), (74, True), (60, False),
                                            (90, False), (0, False)])
def test_reader_needs_the_launches_of_the_calls(launches, reads):
    """24 calls make 72 launches: within 5% the share reads, scaled by the
    launches seen; past it, or with no launch (the parent), nothing."""
    ctx = _ctx(launches)
    assert len(fusion.fusion_calls(ctx)) == 24
    got = bench.reader("fusion_attn_roofline.serve")(ctx)
    if not reads:
        assert got is None
        return
    bound = fusion.fusion_attn_bound(2, 20197, 256)[0]
    assert got == pytest.approx(100.0 * bound * launches / 3 / 1e-3)


def test_reader_reads_nothing_without_fusion_layers():
    ctx = _ctx(72, use_fusion=False)
    assert fusion.fusion_calls(ctx) == []
    assert bench.reader("fusion_attn_roofline.serve")(ctx) is None
