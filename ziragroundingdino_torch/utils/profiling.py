"""Profiling and debugging tools, the port of the JAX package's
`utils/profiling.py` (reference: wall-clock timers with
`torch.cuda.synchronize` in the eval loop, `evaluation/evaluator.py:
109-151`; `util/misc.py`'s `SmoothedValue` and `MetricLogger`):
  * `device_timer`: wall time of a block, the device synchronised at its end;
  * `trace`: a `torch.profiler` trace of the block, written as a Chrome
    trace into `log_dir`;
  * `nan_guard` / `checkify_nans`: raise, or return an error object, when a
    module of a model produces a value that is not finite;
  * `SmoothedValue`, `MetricLogger`: windowed averages of training metrics.

The JAX package's `enable_compilation_cache` is XLA's persistent cache of
compiled programs and has no counterpart here: the port's cache of built
kernels is `ops/cuda_build.py`'s build directory, where each CUDA source is
compiled once per content hash.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Union

import torch
from torch import nn

logger = logging.getLogger("ziragroundingdino_torch")


def _synchronize(device: Optional[Union[str, torch.device]]) -> None:
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
    _synchronize(device)
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


class SmoothedValue:
    """`util/misc.py:33-97` equivalent: windowed median/avg tracker."""

    def __init__(self, window: int = 20):
        self.window = deque(maxlen=window)
        self.total = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.window.append(value)
        self.total += value * n
        self.count += n

    @property
    def avg(self) -> float:
        return sum(self.window) / max(len(self.window), 1)

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)


class MetricLogger:
    """`util/misc.py:248-360` equivalent."""

    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = {}
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters.setdefault(k, SmoothedValue()).update(float(v))

    def __str__(self):
        return self.delimiter.join(f"{k}: {m.avg:.4f}" for k, m in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int, header: str = ""):
        t0 = time.time()
        for i, obj in enumerate(iterable):
            yield obj
            if i % print_freq == 0:
                logger.info("%s [%d] %s (%.1fs)", header, i, str(self), time.time() - t0)
