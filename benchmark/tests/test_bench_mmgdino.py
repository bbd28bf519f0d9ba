"""`mmgdino-l.serve-odinw` through `run.py` on the CPU, at the tiny
configuration with MM-Grounding-DINO-L's layout (Swin's four stages and one
conv level: five levels) in float32: a sound run is `correct` and reports
`serve_img_per_s`; a traced run reports every span metric the cell lists,
the three parts of the replay among them, whose sum stays within
`predictor.run`; the parts' readers read nothing from a program that does
not mark the parts."""

import math

import benchmark.run as bench
from benchmark.tests.test_bench_faults import MANIFEST, run_cell
from benchmark.tests.test_bench_spans import SPAN_METRICS, traced_run

CELL = "mmgdino-l.serve-odinw"
PARTS = ["run_backbone_ms.serve", "run_encoder_ms.serve", "run_decoder_ms.serve"]
# a profiled slice is 30 requests (8 after 22): time for them with other tests beside
SECONDS = "15"


def test_the_cell_is_five_levels_of_swin_l():
    from benchmark.tests.tiny import tiny_config

    w = next(x for x in MANIFEST["workloads"] if x["name"] == CELL)
    conf = tiny_config(w["config"])
    assert conf["model"]["num_feature_levels"] == 5
    assert conf["swin"]["out_indices"] == conf["model"]["return_interm_indices"] == [0, 1, 2, 3]
    assert all(CELL in m["workloads"] for m in MANIFEST["per_layer"] if m["name"] in PARTS)


def test_sound_run_is_correct(monkeypatch, capsys):
    out = run_cell(CELL, monkeypatch, capsys)
    assert out["correct"], out["check"]
    assert out["metrics"]["serve_img_per_s"]["value"] > 0


def test_traced_run_reports_the_parts(monkeypatch, capsys):
    from ziragroundingdino_torch.utils import profiling

    profiling.clear_spans()
    out = traced_run(CELL, monkeypatch, capsys, SECONDS)
    assert out["correct"], out["check"]
    wanted = [m["name"] for m in SPAN_METRICS if CELL in m["workloads"]]
    assert set(PARTS) <= set(wanted)
    got = {name: out["metrics"][name]["value"] for name in wanted}
    assert all(math.isfinite(v) and v > 0 for v in got.values()), got
    assert sum(got[name] for name in PARTS) <= got["predictor_run_ms.serve"]


def test_parts_read_nothing_from_a_program_without_marks(monkeypatch, capsys):
    """The parent's program: spans, but no part of the replay."""
    import contextlib

    from ziragroundingdino_torch.utils import profiling

    class Unmarked:
        def record(self, prefix):
            pass

    @contextlib.contextmanager
    def parts(first, device):
        yield Unmarked()

    monkeypatch.setattr(profiling, "parts", parts)
    profiling.clear_spans()
    out = traced_run(CELL, monkeypatch, capsys, SECONDS)
    assert out["correct"] and "predictor_run_ms.serve" in out["metrics"]
    for name in PARTS:
        assert name not in out["metrics"]
        assert bench.reader(name)(None) is None
