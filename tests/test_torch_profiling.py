"""The port's `utils/profiling.py` on the CPU: `SmoothedValue` and
`MetricLogger` against the JAX package's classes on the same updates,
`nan_guard` / `checkify_nans` on a forward that makes a NaN and on one that
does not, `device_timer` recording into `results`, `trace` writing a
Chrome trace."""

import json
import math

import numpy as np
import pytest
import torch
from torch import nn

from ziragroundingdino_torch.utils import profiling


def _updates():
    rng = np.random.RandomState(0)
    return [(float(v), int(n)) for v, n in zip(rng.randn(45), rng.randint(1, 4, 45))]


def test_smoothed_value_and_metric_logger_match_jax():
    from ziragroundingdino_tpu.utils import profiling as jprof

    for window in (1, 7, 20):
        got, want = profiling.SmoothedValue(window), jprof.SmoothedValue(window)
        for v, n in _updates():
            got.update(v, n)
            want.update(v, n)
            assert (got.avg, got.global_avg, got.count) == (want.avg, want.global_avg,
                                                            want.count)
    got, want = profiling.MetricLogger(delimiter=" | "), jprof.MetricLogger(delimiter=" | ")
    for i, (v, _) in enumerate(_updates()):
        kw = {"loss": v, "lr": 1e-4 * i} if i % 3 else {"loss": torch.tensor(v)}
        got.update(**kw)
        want.update(**{k: float(x) for k, x in kw.items()})
    assert str(got) == str(want)
    assert list(got.log_every(range(5), 2, "it")) == list(want.log_every(range(5), 2, "it"))


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
