"""The readers of the program's own spans and counters (those built on
`benchmark/lib/spans.py`) in a `--trace 1` run of the harness on
the CPU, at the tiny configuration in float32: each reports a finite number
in the cells it lists, `correct` stays true, and each reads None from an
empty span store and from a program that records no span."""

import json
import math

import pytest

import benchmark.run as bench
from benchmark.tests.test_bench_faults import SERVE, TRAIN
from benchmark.tests.tiny import tiny_config, tiny_mix

MANIFEST = json.loads((bench.ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = [m for m in MANIFEST["per_layer"] if "benchmark.lib.spans"
                in (bench.BENCH / "metrics" / f"{m['name']}.py").read_text()]


def traced_run(cell, monkeypatch, capsys, seconds):
    w = next(x for x in MANIFEST["workloads"] if x["name"] == cell)
    conf = tiny_config(w["config"])
    conf["model"]["compute_dtype"] = "float32"
    mix = tiny_mix(w["traffic"])
    limits = SERVE if mix["kind"] == "serve" else TRAIN
    monkeypatch.setattr(bench, "load_cell", lambda name: (MANIFEST, w, conf, mix, limits))
    assert bench.main(["--workload", cell, "--seed", str(2**31 + 33), "--seconds", seconds,
                       "--trace", "1"], device_override="cpu") == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# one profiled slice needs 30 requests (serving) or 6 steps (training)
@pytest.mark.parametrize("cell,seconds", [("zira-t.serve-odinw", "8"),
                                          ("zira-t.serve-coco", "8"),
                                          ("zira-t.train-b8", "8")])
def test_traced_run_reports_the_span_metrics(cell, seconds, monkeypatch, capsys):
    from ziragroundingdino_torch.utils import profiling

    profiling.clear_spans()
    out = traced_run(cell, monkeypatch, capsys, seconds)
    assert out["correct"], out["check"]
    wanted = [m["name"] for m in SPAN_METRICS if cell in m["workloads"]]
    assert len(wanted) == (7 if "serve" in cell else 3)
    for name in wanted:
        value = out["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0, (name, value)
    for name in ("pixel_fill.serve", "token_fill.serve"):
        if name in wanted:
            assert out["metrics"][name]["value"] <= 100.0


@pytest.mark.parametrize("m", SPAN_METRICS, ids=lambda m: m["name"])
def test_reader_reads_none_without_spans(m, monkeypatch):
    from ziragroundingdino_torch.utils import profiling

    profiling.clear_spans()
    assert bench.reader(m["name"])(None) is None
    monkeypatch.delattr(profiling, "spans")  # a program that records no span
    assert bench.reader(m["name"])(None) is None
