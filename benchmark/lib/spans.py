"""What the per-layer readers of the program's own spans share. The port
records its spans (`ziragroundingdino_torch.utils.profiling.span`) only while
a `torch.profiler` records, so in a `--trace 1` run its store holds the
profiled slices' requests and steps alone. A program that records no span
(a port without `profiling.spans`) gives None, and its metrics are left out
of the result line."""

from __future__ import annotations

from typing import List, Optional


def records() -> Optional[List]:
    """The program's finished spans (stream times resolved), or None."""
    from ziragroundingdino_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    return read() if read is not None else None


def ms_per_root(root: str, child: str, stream: bool) -> Optional[float]:
    """The milliseconds of the spans named `child` directly under a span
    named `root`, summed, over the number of `root` spans: per request or
    per step. `stream`: the span's stream time where it has one (on the
    card; host time on the CPU), else its host time. None where no such
    root or child was recorded."""
    recs = records()
    if not recs:
        return None
    roots = {r.seq for r in recs if r.name == root}
    kids = [r for r in recs if r.name == child and r.parent in roots]
    if not kids:
        return None
    return sum(r.ms if stream else r.host_ms for r in kids) / len(roots)


def fill(real: str, padded: str) -> Optional[float]:
    """100 x the sum of the count `real` over the sum of the count `padded`
    of the recorded `predictor.request` spans, in %."""
    reqs = [r for r in records() or () if r.name == "predictor.request" and padded in r.counts]
    total = sum(r.counts[padded] for r in reqs)
    return 100.0 * sum(r.counts[real] for r in reqs) / total if total else None
