"""Instruments the traced run puts on the program from outside it.

Training (one card or data-parallel: rank 0's): CUDA events around `Optimizer.step`, wrapped on the instance (as
`chip_smoke.py::record_gradients` wraps it), and around every call of the
encoder's layer modules (fusion, text, deformable) from forward pre- and
post-hooks: a call of each in the forward, and again in the backward where
remat recomputes it (the `chip_smoke.py --profile` method; stream times,
sound in eager). Serving needs none: the Predictor's host time is read from
the profiler's events.

`instrument(run, device)` returns {name: function giving the per-step
milliseconds}, to be called once the window has closed.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch


def _events_ms(pairs: List[list]) -> List[float]:
    """Each finished pair's milliseconds. A pair whose end was never
    recorded is left out: remat's non-reentrant recompute stops once it has
    what the backward needs, and a layer's forward stopped there never
    reaches its post-hook."""
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b, done in pairs if done[0]]


def instrument(run, device) -> Dict[str, Callable[[], List[float]]]:
    if run.mix["kind"] == "serve" or device.type != "cuda":
        return {}
    optim: List[List[torch.cuda.Event]] = []
    encoder: List[List[torch.cuda.Event]] = []
    steps = {"n": 0}
    opt = run.opt
    inner = opt.step

    def timed_step():
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = inner()
        b.record()
        optim.append([a, b, [True]])
        steps["n"] += 1
        return out

    opt.step = timed_step
    enc = run.model.transformer.encoder
    mods = list(enc.layers) + list(enc.text_layers or []) + list(enc.fusion_layers or [])

    open_calls = {}

    def pre(mod, args):
        pair = [torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True),
                [False]]
        pair[0].record()
        encoder.append(pair)
        open_calls[id(mod)] = pair

    def post(mod, args, out):
        pair = open_calls.pop(id(mod))
        pair[1].record()
        pair[2][0] = True

    for m in mods:
        m.register_forward_pre_hook(pre)
        m.register_forward_hook(post)

    def optim_ms():
        return _events_ms(optim)

    def encoder_ms():
        total = sum(_events_ms(encoder))
        return [total / max(steps["n"], 1)]

    return {"optim_ms": optim_ms, "encoder_ms": encoder_ms}
