"""The yardstick's arithmetic: the chip's peaks, the model FLOPs of the work
a run completes, and the bytes bounds of the MSDA kernels.

Model FLOPs are counted by `torch.utils.flop_counter.FlopCounterMode` over
the benchmark's own reference (`benchmark/reference/model.py`) on the meta
device, at each image's resized size (rounded up to the patch's multiple of
4, the least the architecture takes; no bucket padding) and each caption's
real token count. The reference's MSDA is a gather and a product over the
4 corners of every sample, which the counter sees as a matrix product (2 x
D per corner), so the sampling is counted. A training step counts the
forward and the backward that the step needs: the input gradients down to
the earliest trainable tensor and the weight gradients of the trainable
tensors, as autograd computes them on the meta device; remat's recompute is
not counted. So the count does not depend on how the program implements
the model, and a program that cuts padding shows a higher share.

Counting the whole model takes seconds on the meta device, so `ModelFlops`
counts the backbone at each image size and solves the rest's exact linear
form once per process (see its doc); `tests/test_bench_counts.py` holds it
to direct counts.

`msda_forward_bound` / `msda_backward_bound` are copies of
`chip_smoke.py::msda_bound` / `msda_backward_bound` at given shapes: every
input read once and every output written once at the HBM rate, or the
arithmetic at the float32 rate, whichever is longer.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

# NVIDIA H100 SXM data sheet (dense, 700 W)
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def level_shapes(h: int, w: int, levels: int = 4,
                 indices: Sequence[int] = (1, 2, 3)) -> List[Tuple[int, int]]:
    """The encoder's feature-map sizes for an (h, w) input: Swin's stages
    `indices` (stage i at stride 2^(2 + i): the patch embedding's 4, then
    each patch merge halves, padding an odd side), then extra stride-2 conv
    levels up to `levels`."""
    hh, ww = math.ceil(h / 4), math.ceil(w / 4)
    out = []
    for i in range(max(indices) + 1):
        if i:
            hh, ww = math.ceil(hh / 2), math.ceil(ww / 2)
        if i in indices:
            out.append((hh, ww))
    while len(out) < levels:
        hh, ww = math.ceil(hh / 2), math.ceil(ww / 2)
        out.append((hh, ww))
    return out[:levels]


def conf_level_shapes(conf: Dict, h: int, w: int) -> List[Tuple[int, int]]:
    """`level_shapes` at a configuration's `return_interm_indices` and
    `num_feature_levels`."""
    m = conf["model"]
    return level_shapes(h, w, m["num_feature_levels"], tuple(m["return_interm_indices"]))


def msda_forward_bound(b: int, q: int, s: int, heads: int = 8, d: int = 32, levels: int = 4,
                       points: int = 4, value_bytes: int = 2) -> Tuple[float, int]:
    """(least seconds, bytes) of one forward call: value [B, S, H, D] in the
    compute dtype, loc [B, Q, H, L, P, 2] and attn [B, Q, H, L, P] f32, the
    output [B, Q, H*D] in the value's dtype."""
    samples = b * q * heads * levels * points
    nbytes = (b * s * heads * d * value_bytes + samples * 2 * 4 + samples * 4
              + b * q * heads * d * value_bytes)
    flops = samples * (4 * 2 * d + 20)
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS), nbytes


def msda_backward_bound(b: int, q: int, s: int, heads: int = 8, d: int = 32, levels: int = 4,
                        points: int = 4, value_bytes: int = 2) -> Tuple[float, int]:
    """(least seconds, bytes) of one backward call: value, loc, attn and
    grad_out read once; d_value (value's dtype), d_loc and d_attn (f32)
    written once."""
    samples = b * q * heads * levels * points
    value = b * s * heads * d * value_bytes
    nbytes = (value + samples * 2 * 4 + samples * 4 + b * q * heads * d * value_bytes
              + value + 4 * (samples * 2 + samples))
    flops = samples * (4 * 4 * d + 40)
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS), nbytes


class ModelFlops:
    """Model FLOPs of one image of a configuration, cached by (h, w, T).

    The count splits into the backbone's, counted directly at each image
    size, and the rest's (input projections, BERT, encoder, selection,
    decoder, heads), which is exactly linear in the features [N_0, ..,
    N_{L-1} (tokens per level, one per level of `num_feature_levels`), S * T
    (S = their sum), 1, T, T^2]: every product
    after the backbone runs over the tokens of one level, over all of
    them (the fusion and the two-stage head, times T), over the text
    tokens or over the 900 queries. The rest's coefficients are solved from
    counts at `FIT_POINTS` level sizes, or L + 4 where that is more (the
    backbone replaced by a stub that only shapes its outputs), and checked
    on one more before any use."""

    FIT_POINTS = 8

    def __init__(self, conf: Dict, train: bool, trainable: Sequence[str] = ("adapter",)):
        from benchmark.reference.model import GroundingDINO, RefConfig

        self.c = RefConfig.from_file(conf)
        self.train = train
        self.indices = tuple(conf["model"]["return_interm_indices"])
        self.levels = conf["model"]["num_feature_levels"]
        with torch.device("meta"):
            # one gather over all queries: the meta device holds no memory
            self.model = GroundingDINO(self.c).configure(msda_chunk=1 << 40)
        self.model.train(train)
        for n, p in self.model.named_parameters():
            p.requires_grad_(train and any(t in n for t in trainable))
        self.channels = self.model.backbone[0].out_channels
        self._swin: Dict[Tuple[int, int], int] = {}
        self._cache: Dict[Tuple[int, int, int], int] = {}
        self._coef = None

    # -- counting on the meta device
    def _count(self, h: int, w: int, t: int, stub=None, backbone_only: bool = False) -> int:
        from torch.utils.flop_counter import FlopCounterMode

        dev = torch.device("meta")
        px = torch.empty(1, h, w, 3, device=dev)
        mask = torch.ones(1, h, w, dtype=torch.bool, device=dev)
        text = {"input_ids": torch.zeros(1, t, dtype=torch.long, device=dev),
                "text_token_mask": torch.ones(1, t, dtype=torch.bool, device=dev),
                "position_ids": torch.zeros(1, t, dtype=torch.long, device=dev),
                "text_self_attention_masks": torch.ones(1, t, t, dtype=torch.bool, device=dev)}
        body = self.model.backbone[0]
        if stub is not None:
            body.forward = stub
        try:
            with FlopCounterMode(display=False) as fc, torch.set_grad_enabled(self.train):
                if backbone_only:
                    body(px, mask, None)
                else:
                    out = self.model(px, mask, text, train=self.train)
                    if self.train:
                        parts = [out] + out["aux_outputs"] + [out["interm_outputs"]]
                        loss = sum(o["pred_logits"].sum() + o["pred_boxes"].sum() for o in parts)
                        loss = loss + out["loss_conv_adapter"] + out["loss_linear_adapter"]
                        loss.backward()
        finally:
            if stub is not None:
                del body.forward
        return int(fc.get_total_flops())

    def direct(self, h: int, w: int, t: int) -> int:
        """The whole model counted at once (h, w multiples of 4)."""
        return self._count(h, w, t)

    def swin(self, h: int, w: int) -> int:
        if (h, w) not in self._swin:
            self._swin[(h, w)] = self._count(h, w, 8, backbone_only=True)
        return self._swin[(h, w)]

    def rest(self, shapes: Sequence[Tuple[int, int]], t: int) -> int:
        """The rest counted with the backbone's outputs at `shapes` (one a
        backbone level)."""
        dev = torch.device("meta")
        feats = [(torch.empty(1, hh, ww, ch, device=dev),
                  torch.ones(1, hh, ww, dtype=torch.bool, device=dev))
                 for (hh, ww), ch in zip(shapes, self.channels)]
        stride = 2 ** (2 + min(self.indices))
        h, w = stride * shapes[0][0], stride * shapes[0][1]
        return self._count(h, w, t, stub=lambda *a, **k: feats)

    def features(self, shapes: Sequence[Tuple[int, int]], t: int) -> List[float]:
        """The features of the backbone's level sizes `shapes`: every level's
        tokens, the extra levels' after the backbone's."""
        n = [hh * ww for hh, ww in shapes]
        hh, ww = shapes[-1]
        while len(n) < self.levels:
            hh, ww = math.ceil(hh / 2), math.ceil(ww / 2)
            n.append(hh * ww)
        s = sum(n)
        return [float(x) for x in n] + [float(s * t), 1.0, float(t), float(t * t)]

    def _fit(self):
        import numpy as np

        rng = np.random.default_rng(0)
        rows, vals = [], []
        nb = len(self.channels)
        n = max(self.FIT_POINTS, self.levels + 4)
        for i in range(n + 1):
            # level 0 holds more tokens than the queries, as every real image does
            shapes = [(int(rng.integers(8, 30)) * 2 ** (nb - 1 - k) + int(rng.integers(0, 2)),
                       int(rng.integers(8, 30)) * 2 ** (nb - 1 - k) + int(rng.integers(0, 2)))
                      for k in range(nb)]
            t = int(rng.integers(3, 40))
            rows.append(self.features(shapes, t))
            vals.append(self.rest(shapes, t))
        a = np.array(rows, np.float64)
        b = np.array(vals, np.float64)
        coef = np.linalg.lstsq(a[:n], b[:n], rcond=None)[0]
        check = np.rint(a[n:] @ coef)
        if not np.array_equal(check, b[n:]):
            raise AssertionError(f"the rest's FLOPs are not linear in {a.shape[1]} features: "
                                 f"{check.tolist()} against {b[n:].tolist()}")
        self._coef = coef

    def __call__(self, h: int, w: int, t: int) -> int:
        """FLOPs of an image resized to (h, w) with a caption of t tokens."""
        h, w = 4 * math.ceil(h / 4), 4 * math.ceil(w / 4)
        key = (h, w, t)
        if key not in self._cache:
            if self._coef is None:
                self._fit()
            shapes = level_shapes(h, w, len(self.indices), self.indices)
            rest = float(sum(c * f for c, f in zip(self._coef, self.features(shapes, t))))
            self._cache[key] = self.swin(h, w) + int(round(rest))
        return self._cache[key]
