"""The traced run (`--trace 1`): `torch.profiler` over spaced slices of the
window, reduced to aggregates as each slice ends. Nothing of the trace is
written to disk.

A slice is `active` consecutive steps (requests or train steps) after
`wait` + `warmup` unprofiled ones, repeated over the whole window. Each
step runs inside a `record_function("bench.step.<n>")` range, and the
trace's ranges say which steps a slice holds. A training slice
starts and ends on a synchronise, and the warm-up step before it ends on
one too, so that no kernel of an earlier step runs once the profiler
records (its launch would lie outside the trace). For
each slice: its window (the first step range's start to the last one's
end, on the profiler's clock), the device's busy time (the union of the
intervals of every kernel, copy and set on the device, clipped to the
window: `chip_smoke.py::profile_window`'s arithmetic), device time by
kernel name of the kernels that start inside the window, the idle gaps between busy intervals by the host operation
that was running at each gap's middle ("python" where none was), the
device time launched under `_MSDAFunctionBackward` autograd nodes, the MSDA
forward launches made from the backward (remat's recompute), the time in
which a collective kernel (`nccl...`) ran and no other device operation
did (the collectives' exposed time), and per request the host time from
the step's start to its `cudaGraphLaunch`.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

import torch

SCHEDULES = {"serve": dict(wait=20, warmup=2, active=8),
             "train": dict(wait=3, warmup=1, active=2)}
GAP_MIN_US = 5.0  # shorter idle gaps are not attributed
FORWARD_KERNEL = "msda_forward_kernel"
COLLECTIVE = "nccl"  # the start of a collective kernel's name


def overlap(a: List[Tuple[float, float]], b: List[Tuple[float, float]]) -> float:
    """The length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


@dataclass
class TraceResult:
    kind: str
    window_s: float = 0.0
    busy_s: float = 0.0
    kernel_s: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    launches: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    gaps_s: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    msda_bwd_s: float = 0.0
    collective_exposed_s: float = 0.0
    from_backward: Dict[str, Tuple[float, int]] = field(default_factory=dict)
    prep_ms: List[float] = field(default_factory=list)
    items: List[Any] = field(default_factory=list)  # the profiled steps' requests or batches
    slices: int = 0

    def device_s(self, part: str) -> Tuple[float, int]:
        """(device seconds, launches) of the kernels whose name holds `part`."""
        names = [k for k in self.kernel_s if part in k]
        return sum(self.kernel_s[k] for k in names), sum(self.launches[k] for k in names)

    def forward_device_s(self, part: str) -> Tuple[float, int]:
        """`device_s` less the launches made from the backward (remat's
        recompute of a forward)."""
        seconds, launches = self.device_s(part)
        back_s, back_n = self.from_backward.get(part, (0.0, 0))
        return seconds - back_s, launches - back_n

    def breakdown(self) -> Dict[str, List]:
        top = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps_s.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}


class Tracer:
    def __init__(self, kind: str, device: torch.device):
        from torch.profiler import ProfilerActivity, profile, schedule

        self.kind = kind
        self.device = device
        self.result = TraceResult(kind)
        self.pending: Dict[int, Any] = {}  # step -> its request or batch, in profiled slices
        sched = schedule(repeat=0, **SCHEDULES[kind])
        self._schedule = sched
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                            schedule=sched, on_trace_ready=self._ready)
        self._range = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        self.prof.__enter__()

    def stop(self):
        self.prof.__exit__(None, None, None)

    def _action(self):
        return self._schedule(self.prof.step_num)

    def begin(self, step: int, item) -> None:
        from torch.profiler import ProfilerAction

        if self._action() in (ProfilerAction.RECORD, ProfilerAction.RECORD_AND_SAVE):
            if self.kind == "train" and not self.pending:
                self._sync()
            self.pending[step] = item
        self._range = torch.profiler.record_function(f"bench.step.{step}")
        self._range.__enter__()

    def end(self, step: int) -> None:
        from torch.profiler import ProfilerAction

        if self.kind == "train" and self._action() in (ProfilerAction.WARMUP,
                                                        ProfilerAction.RECORD_AND_SAVE):
            self._sync()
        self._range.__exit__(None, None, None)
        self.prof.step()

    # ------------------------------------------------------------------ reduce
    def _ready(self, prof) -> None:
        from torch.autograd import DeviceType

        r = self.result
        events = prof.events()
        steps = [e for e in events if e.name.startswith("bench.step.")
                 and e.device_type == DeviceType.CPU]
        # the profiled steps are the ones whose ranges the trace holds
        items = [self.pending[i] for i in sorted({int(e.name.rsplit(".", 1)[1]) for e in steps})
                 if i in self.pending]
        self.pending = {}
        if not steps or not items:
            return
        w0 = min(e.time_range.start for e in steps)
        w1 = max(e.time_range.end for e in steps)
        dev = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
        spans, coll, other = [], [], []
        for e in dev:
            a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
            if w0 <= e.time_range.start <= w1:
                r.kernel_s[e.name] += e.time_range.elapsed_us() * 1e-6
                r.launches[e.name] += 1
            if b > a:
                spans.append((a, b))
                (coll if e.name.startswith(COLLECTIVE) else other).append((a, b))
        busy = merged(spans)
        r.busy_s += sum(b - a for a, b in busy) * 1e-6
        coll = merged(coll)
        r.collective_exposed_s += (sum(b - a for a, b in coll)
                                   - overlap(coll, merged(other))) * 1e-6
        r.window_s += (w1 - w0) * 1e-6
        # idle gaps, by the innermost host operation running at their middle
        cpu = [e for e in events if e.device_type == DeviceType.CPU
               and not e.name.startswith(("bench.step.", "ProfilerStep"))]
        cpu.sort(key=lambda e: e.time_range.start)
        starts = [e.time_range.start for e in cpu]
        edges = [w0] + [x for ab in busy for x in ab] + [w1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] - edges[i] >= GAP_MIN_US]
        for a, b in gaps:
            mid = 0.5 * (a + b)
            name = "python"
            # the latest-starting host operation that still runs at `mid`
            for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                if cpu[j].time_range.end >= mid:
                    name = cpu[j].name
                    break
                if mid - starts[j] > 1e6:
                    break
            r.gaps_s[name] += (b - a) * 1e-6
        for e in events:
            if e.device_type != DeviceType.CPU or "evaluate_function" not in e.name:
                continue
            if "_MSDAFunctionBackward" in e.name:
                r.msda_bwd_s += e.device_time_total * 1e-6
            # forward kernels launched from the backward: remat's recompute
            stack = [e]
            while stack:
                x = stack.pop()
                for k in x.kernels:
                    if FORWARD_KERNEL in k.name:
                        s_, n_ = r.from_backward.get(FORWARD_KERNEL, (0.0, 0))
                        r.from_backward[FORWARD_KERNEL] = (s_ + k.duration * 1e-6, n_ + 1)
                stack.extend(x.cpu_children)
        if self.kind == "serve":
            launches = [e for e in events if e.name == "cudaGraphLaunch"]
            for s in steps:
                inside = [e.time_range.start for e in launches
                          if s.time_range.start <= e.time_range.start <= s.time_range.end]
                if inside:
                    r.prep_ms.append((min(inside) - s.time_range.start) * 1e-3)
        r.items.extend(items)
        r.slices += 1
