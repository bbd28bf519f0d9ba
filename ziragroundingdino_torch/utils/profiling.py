"""Profiling and debugging tools, the port of the JAX package's
`utils/profiling.py` (reference: wall-clock timers with
`torch.cuda.synchronize` in the eval loop, `evaluation/evaluator.py:
109-151`):
  * `device_timer`: wall time of a block, the device synchronised at its end;
  * `trace`: a `torch.profiler` trace of the block, written as a Chrome
    trace into `log_dir`;
  * `span` / `spans` / `clear_spans`: named spans inside the program (the
    Predictor's host path, the train step's phases, the model's layers),
    recorded while a `torch.profiler` records and read back afterwards;
  * `parts` / `mark`: the boundaries of a forward's parts (text, backbone,
    encoder, decoder), kept as timing events inside a captured CUDA graph,
    so that a replay's parts become spans with stream times;
  * `nan_guard` / `checkify_nans`: raise, or return an error object, when a
    module of a model produces a value that is not finite.

The JAX package's `enable_compilation_cache` is XLA's persistent cache of
compiled programs and has no counterpart here: the port's cache of built
kernels is `ops/cuda_build.py`'s build directory, where each CUDA source is
compiled once per content hash.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Union

import torch
import torch.autograd.profiler as _autograd_profiler
from torch import nn

logger = logging.getLogger("ziragroundingdino_torch")


def synchronize(device: Optional[Union[str, torch.device]] = None) -> None:
    """Wait for `device`'s work (None: the current card, if any); nothing
    on the CPU."""
    device = torch.device(device) if device is not None else None
    if device is None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    elif device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def device_timer(name: str, results: Optional[Dict[str, float]] = None,
                 device: Optional[Union[str, torch.device]] = None):
    """Wall time of the block in seconds, with a `torch.cuda.synchronize` of
    `device` (the model's; None: the current card, if any) at its end, so
    the device's work counts. Added to `results[name]` when given."""
    t0 = time.perf_counter()
    yield
    synchronize(device)
    dt = time.perf_counter() - t0
    if results is not None:
        results[name] = results.get(name, 0.0) + dt
    logger.info("%s: %.1f ms", name, dt * 1000)


@contextlib.contextmanager
def trace(log_dir: str = "profile"):
    """A `torch.profiler` trace of the block (the CPU and, with a card, CUDA),
    written as `log_dir/trace.json` (open it in chrome://tracing or
    Perfetto). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    try:
        with prof:
            yield prof
    finally:
        path = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(path)
        logger.info("profile written to %s", path)


SPAN_LIMIT = 200_000  # finished spans kept; past it the oldest go first


@dataclass
class SpanRecord:
    """One finished span. `seq` numbers every span of the process; `parent`
    is the `seq` of the span that was open around it (None for a root);
    `id` is its root's: the request or the step it belongs to. `start_ns` /
    `end_ns` are `time.perf_counter_ns()`. `device_ms` is the stream time
    between its two timing events (None where it recorded none: on the
    CPU, or begun while its stream captured a graph). `error`: closed by
    an exception."""

    name: str
    seq: int
    parent: Optional[int]
    id: int
    start_ns: int
    end_ns: int = 0
    counts: Dict[str, float] = field(default_factory=dict)
    error: bool = False
    device_ms: Optional[float] = None
    events: Optional[tuple] = field(default=None, repr=False)

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    @property
    def ms(self) -> float:
        """Stream milliseconds where the span has them, else host ones."""
        return self.host_ms if self.device_ms is None else self.device_ms


class _SpanStore:
    """The process's spans: the finished records (bounded) and the stack of
    open ones. The stack is the process's, not a thread's: remat recomputes
    layers on the autograd engine's thread while the caller waits inside
    its `backward()`, and those spans belong to that step."""

    def __init__(self):
        self.lock = threading.Lock()
        self.done: deque = deque(maxlen=SPAN_LIMIT)
        self.open: List[SpanRecord] = []
        self.seqs = itertools.count(1)
        self.ids = itertools.count(1)

    def child(self, name: str, **fields) -> SpanRecord:
        """A new record named `name` under the innermost open span (a root
        where none is open). Call it holding `lock`."""
        parent = self.open[-1] if self.open else None
        return SpanRecord(name, next(self.seqs), parent.seq if parent else None,
                          parent.id if parent else next(self.ids), **fields)


_STORE = _SpanStore()


class _NullSpan:
    """What `span` returns while no profiler records: it does nothing."""

    recording = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, **counts) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    recording = True

    def __init__(self, name: str, stream: bool, counts: Dict[str, float]):
        self.name, self.stream, self.counts = name, stream, counts

    def __enter__(self):
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        store = _STORE
        with store.lock:
            rec = store.child(self.name, start_ns=0, counts=self.counts)
            store.open.append(rec)
        self.rec = rec
        if (self.stream and torch.cuda.is_initialized()
                and not torch.cuda.is_current_stream_capturing()):
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record()
        rec.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        rec = self.rec
        rec.end_ns = time.perf_counter_ns()
        if rec.events is not None:
            rec.events[1].record()
        rec.error = exc_type is not None
        store = _STORE
        with store.lock:
            # the innermost first; a span closed out of order is found too
            for i in range(len(store.open) - 1, -1, -1):
                if store.open[i] is rec:
                    del store.open[i]
                    break
            store.done.append(rec)
        self.range.__exit__(exc_type, exc, tb)
        return False

    def count(self, **counts) -> None:
        """Add counts to the span (known only once some of its work is done)."""
        self.rec.counts.update(counts)


def span(name: str, *, stream: bool = True, **counts):
    """A context manager that records the block as a span named `name`,
    with `counts` (numbers: images, pixels, tokens), only while a
    `torch.profiler` records (a schedule's active steps; `trace()`): else it
    is a shared no-op, and the cost is one flag read. A recorded span opens
    `torch.profiler.record_function(name)`, so it sits on the profiler's
    timeline with the device's kernels, and keeps a `SpanRecord`: host
    start and end, its parent (the innermost span open in the process), the
    id of its root, the counts (more through `.count(...)` on what `with`
    gives), and on a card, unless `stream` is False or the current stream
    is capturing a graph, a pair of timing events on the current stream.
    `.recording` says whether it records."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL_SPAN
    return _Span(name, stream, counts)


def spans() -> List[SpanRecord]:
    """The finished spans, oldest first, their `device_ms` resolved (one
    synchronise where some are pending)."""
    with _STORE.lock:
        out = list(_STORE.done)
    pending = [r for r in out if r.events is not None]
    if pending:
        torch.cuda.synchronize()
        for r in pending:
            r.device_ms = r.events[0].elapsed_time(r.events[1])
            r.events = None
    return out


def clear_spans() -> None:
    """Forget the finished spans."""
    with _STORE.lock:
        _STORE.done.clear()


class Parts:
    """The boundaries of a forward's parts, in order: (name, stamp) where
    each part starts, then (None, stamp) where the last ends. A stamp is a
    timing event recorded on the current stream on a card (external, so a
    graph being captured keeps it as a node and records it again on every
    replay), the host's `perf_counter_ns` on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: List[tuple] = []

    def add(self, name: Optional[str]) -> None:
        if self.cuda:
            stamp = torch.cuda.Event(enable_timing=True, external=True)
            stamp.record()
        else:
            stamp = time.perf_counter_ns()
        self.marks.append((name, stamp))

    def record(self, prefix: str) -> None:
        """While a `torch.profiler` records, one finished span a part, named
        `<prefix>.<part>`, as a child of the innermost open span: on a card
        with the stream time between its two events (call it once the
        stream has passed the last; host times are then the call's), on the
        CPU with the host times between its two stamps."""
        if not _autograd_profiler._is_profiler_enabled:
            return
        now = time.perf_counter_ns()
        timed = []
        for (name, a), (_, b) in zip(self.marks, self.marks[1:]):
            if self.cuda:
                timed.append((name, now, now, a.elapsed_time(b)))
            else:
                timed.append((name, a, b, None))
        store = _STORE
        with store.lock:
            for name, start, end, ms in timed:
                store.done.append(store.child(f"{prefix}.{name}", start_ns=start, end_ns=end,
                                              device_ms=ms))


_PARTS: Optional[Parts] = None  # the innermost open `parts` block's


@contextlib.contextmanager
def parts(first: str, device: torch.device):
    """Collect the boundaries of the block's parts: the first, `first`,
    starts at the block's start, each `mark(name)` inside starts the next,
    and the last ends with the block. Yields the `Parts`, whose `record`
    turns them into spans. Opened around a capture, the boundaries are
    nodes of the graph: each replay records them, at no host cost."""
    global _PARTS
    found = Parts(device)
    found.add(first)
    outer, _PARTS = _PARTS, found
    try:
        yield found
    finally:
        _PARTS = outer
    found.add(None)


def mark(name: str) -> None:
    """Part `name` of a forward starts here, inside a `parts` block; else
    nothing (one read)."""
    if _PARTS is not None:
        _PARTS.add(name)


class NonFiniteError(FloatingPointError):
    """A module produced a value that is not finite."""


def _first_non_finite(out) -> Optional[str]:
    """'' when a tensor in `out` (a tensor, or lists, tuples and dicts of
    them) holds a value that is not finite, else None; nested outputs name
    their key or position."""
    if isinstance(out, torch.Tensor):
        if out.is_floating_point() and not bool(torch.isfinite(out).all()):
            return ""
        return None
    items = (out.items() if isinstance(out, dict)
             else enumerate(out) if isinstance(out, (list, tuple)) else ())
    for k, v in items:
        where = _first_non_finite(v)
        if where is not None:
            return f"[{k!r}]{where}"
    return None


def _watch(model: nn.Module, found: List[str], stop: bool = False) -> List:
    """Forward hooks on every module of `model` that record, in `found`,
    each module whose output is not finite (innermost first: a module's hook
    runs when it returns); with `stop`, the first one raises."""

    def hook(name):
        def check(mod, args, out):
            where = _first_non_finite(out)
            if where is not None:
                found.append(f"{name or type(mod).__name__}{where}")
                if stop:
                    raise NonFiniteError(f"non-finite output of {found[0]}")
        return check

    return [m.register_forward_hook(hook(n)) for n, m in model.named_modules()]


@contextlib.contextmanager
def nan_guard(model: nn.Module, enable: bool = True):
    """Raise `NonFiniteError` at the first module of `model` whose output
    holds a NaN or an infinity, in a forward run inside the block. Debug
    runs only: every module's output is checked with a sync. The JAX
    version catches NaN production anywhere in jitted code
    (`jax_debug_nans`); this one sees module outputs, through forward hooks
    on every module."""
    if not enable:
        yield
        return
    handles = _watch(model, [], stop=True)
    try:
        yield
    finally:
        for h in handles:
            h.remove()


class NonFiniteReport:
    """What `checkify_nans` found: `.err` is None or the message; `.throw()`
    raises `NonFiniteError` when a module produced a value that is not
    finite (`checkify`'s error object in the JAX package)."""

    def __init__(self, found: List[str]):
        self.found = list(found)
        self.err = f"non-finite output of {found[0]}" if found else None

    def throw(self) -> None:
        if self.err is not None:
            raise NonFiniteError(self.err)


def checkify_nans(model: nn.Module, fn: Callable) -> Callable:
    """`fn` wrapped to return (report, out): the report lists every module of
    `model` whose output held a value that is not finite while `fn` ran, in
    the order they returned; `report.throw()` raises on the first. Nothing
    is raised inside the forward."""

    def wrapped(*args, **kwargs):
        found: List[str] = []
        handles = _watch(model, found)
        try:
            out = fn(*args, **kwargs)
        finally:
            for h in handles:
                h.remove()
        return NonFiniteReport(found), out

    return wrapped
