"""The port's `utils/profiling.py` on the CPU: `nan_guard` /
`checkify_nans` on a forward that makes a NaN and on one that does not,
`device_timer` recording into `results`, `trace` writing a Chrome trace,
and the spans: nothing recorded without a profiler, only a schedule's
active steps recorded under one (their `record_function` ranges around the
ops inside), and the tree of names, parents, ids and counts, a span closed
by an exception kept, a span of another thread under the process's
innermost open span."""

import json
import math
import threading

import pytest
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile, schedule

from ziragroundingdino_torch.utils import profiling


class _Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.inner = nn.Linear(3, 3)
        self.head = nn.Linear(3, 2)

    def forward(self, x):
        return {"out": self.head(torch.log(self.inner(x)))}


def _inputs():
    torch.manual_seed(0)
    net = _Net()
    with torch.no_grad():
        net.inner.weight.copy_(torch.eye(3))
        net.inner.bias.zero_()
    return net, torch.ones(2, 3), -torch.ones(2, 3)  # log(-1) is NaN


def test_nan_guard_raises_on_a_nan_and_is_silent_without():
    net, good, bad = _inputs()
    with profiling.nan_guard(net):
        out = net(good)
    assert torch.isfinite(out["out"]).all()
    with pytest.raises(profiling.NonFiniteError, match=r"of head"):
        with profiling.nan_guard(net):
            net(bad)
    with profiling.nan_guard(net, enable=False):
        assert torch.isnan(net(bad)["out"]).all()
    assert not net._forward_hooks and not net.head._forward_hooks  # hooks removed


def test_checkify_nans_reports_without_raising():
    net, good, bad = _inputs()
    checked = profiling.checkify_nans(net, net)
    report, out = checked(good)
    assert report.err is None
    report.throw()
    report, out = checked(bad)
    assert torch.isnan(out["out"]).all()
    assert report.found == ["head", "_Net['out']"]  # innermost first, then the model
    with pytest.raises(profiling.NonFiniteError, match="head"):
        report.throw()


def test_device_timer_records_into_results(tmp_path):
    results = {}
    for _ in range(2):
        with profiling.device_timer("step", results, device="cpu"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with profiling.device_timer("eval", results, device="cpu"):
        pass
    assert set(results) == {"step", "eval"}
    assert results["step"] > 0.0 and math.isfinite(results["eval"])
    with profiling.trace(str(tmp_path)):
        torch.ones(8) + 1
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any("aten::add" in e.get("name", "") for e in events)


def test_no_span_is_recorded_without_a_profiler():
    profiling.clear_spans()
    with profiling.span("outside", images=1) as s:
        torch.ones(4) + 1
        s.count(pixels_real=3)
    assert not s.recording
    assert profiling.spans() == []


def test_spans_are_recorded_in_the_active_steps_alone():
    profiling.clear_spans()
    traces = []
    with profile(activities=[ProfilerActivity.CPU], schedule=schedule(wait=2, warmup=1, active=2),
                 on_trace_ready=lambda p: traces.append(p.events())) as prof:
        for i in range(7):
            with profiling.span(f"step{i}"):
                torch.ones(4) + i
            prof.step()
    assert [r.name for r in profiling.spans()] == ["step3", "step4"]
    (events,) = traces
    for i in (3, 4):
        (rng,) = [e for e in events if e.name == f"step{i}"]
        inside = [e for e in events if e.name == "aten::add"
                  and rng.time_range.start <= e.time_range.start
                  and e.time_range.end <= rng.time_range.end]
        assert len(inside) == 1
    assert {e.name for e in events} >= {"step3", "step4"}
    assert not {f"step{i}" for i in (0, 1, 2, 5, 6)} & {e.name for e in events}


def test_span_tree_ids_counts_and_exceptions():
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("a", images=2) as a:
            assert a.recording
            with profiling.span("b"):
                with profiling.span("c"):
                    pass
            a.count(pixels_real=10)

            def other():
                with profiling.span("thread"):
                    pass

            # a thread's span: under the process's innermost open span
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
        with pytest.raises(ValueError):
            with profiling.span("e"):
                with profiling.span("f"):
                    raise ValueError("stop")
    got = {r.name: r for r in profiling.spans()}
    assert list(got) == ["c", "b", "thread", "a", "f", "e"]  # in the order they closed
    a, b, c, th, e, f = (got[k] for k in "a b c thread e f".split())
    assert a.parent is None and e.parent is None and a.id != e.id
    assert (b.parent, c.parent, th.parent, f.parent) == (a.seq, b.seq, a.seq, e.seq)
    assert b.id == c.id == th.id == a.id and f.id == e.id
    assert len({r.seq for r in got.values()}) == 6
    assert a.counts == {"images": 2, "pixels_real": 10} and b.counts == {}
    assert e.error and f.error and not (a.error or b.error or c.error)
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns <= a.end_ns
    assert all(r.device_ms is None and r.ms == r.host_ms >= 0 for r in got.values())
    profiling.clear_spans()
    assert profiling.spans() == []
