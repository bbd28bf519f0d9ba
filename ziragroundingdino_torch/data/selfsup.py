"""Self-supervised patch proposals (UP-DETR-style pretraining), the port of
the JAX package's `data/selfsup.py` (reference
`SelfSupervisionDetrDatasetMapper`, `datasets/detr_dataset_mapper.py:
140-257`): at train time the mapper attaches class-agnostic `patch_boxes`,
proposals of selective search on a `res_size`-square resize of the augmented
image, scaled back to image coordinates as float xyxy.

The reference calls OpenCV-contrib's `SelectiveSearchSegmentation` ("fast",
a random base scale). Its two stages are written here in numpy, as in the
JAX package:

1. Felzenszwalb-Huttenlocher graph segmentation (IJCV 2004) of the
   downscaled image: RGB distances over the 8-neighbourhood, union-find
   with the adaptive threshold tau(C) = k / |C|, then a min-size cleanup;
2. greedy merging of adjacent regions by colour and size similarity,
   every region's box along the hierarchy being a proposal.

`k` is drawn from the reference's range (50 + rand * 100) with the
caller's RNG, so both packages draw the same proposals.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ziragroundingdino_torch.config import DataConfig
from ziragroundingdino_torch.data.transforms import Sample, eval_transform, train_transform


_PRECISION_BITS = 22  # Pillow's fixed point for 8-bit images (32 - 8 - 2)


def _bilinear_taps(in_size: int, out_size: int):
    """Pillow's `precompute_coeffs` for its bilinear filter and
    `normalize_coeffs_8bpc`: (first input index [out], fixed-point weights
    [out, ksize] int64, zero past each output's taps), in float64 and in
    Pillow's order of operations."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale  # the bilinear filter's support is 1
    ss = 1.0 / filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    taps = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ws = [max(1.0 - abs((x + xmin - center + 0.5) * ss), 0.0)
              for x in range(xmax)]
        ww = 0.0
        for wgt in ws:
            ww += wgt
        for x, wgt in enumerate(ws):
            v = (wgt / ww if ww != 0.0 else wgt) * (1 << _PRECISION_BITS)
            taps[xx, x] = int(v - 0.5) if v < 0 else int(v + 0.5)
        first[xx] = xmin
    return first, taps


def _resample_rows(image: np.ndarray, out_w: int) -> np.ndarray:
    """Pillow's 8-bit horizontal pass: [H, W, 3] uint8 -> [H, out_w, 3]."""
    first, taps = _bilinear_taps(image.shape[1], out_w)
    cols = np.minimum(first[:, None] + np.arange(taps.shape[1]), image.shape[1] - 1)
    acc = (image[:, cols].astype(np.int64) * taps[None, :, :, None]).sum(2)
    acc += 1 << (_PRECISION_BITS - 1)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear_pil(image: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """[H, W, 3] uint8 resized as Pillow's `Image.resize(..., BILINEAR)`,
    bit for bit: the horizontal pass, then the vertical one, each in
    Pillow's fixed point (the JAX package resizes with Pillow here)."""
    out = np.ascontiguousarray(image, np.uint8)
    if nw != out.shape[1]:
        out = _resample_rows(out, nw)
    if nh != out.shape[0]:
        out = _resample_rows(out.transpose(1, 0, 2), nh).transpose(1, 0, 2)
    return np.ascontiguousarray(out)


def _felzenszwalb(img: np.ndarray, k: float, min_size: int) -> np.ndarray:
    """Graph-based segmentation of `img` float32 [h, w, 3]: edges in
    ascending weight join two components when the weight is at most both
    components' internal difference + k / size; then components smaller
    than `min_size` merge across their edges. Returns labels [h, w] int32."""
    h, w = img.shape[:2]
    n = h * w
    idx = np.arange(n, dtype=np.int32).reshape(h, w)

    # pre-smoothing (the paper's sigma = 0.8 Gaussian): two passes of a
    # separable [1, 2, 1] / 4 kernel, edge-padded
    for _ in range(2):
        p = np.pad(img, ((1, 1), (0, 0), (0, 0)), mode="edge")
        img = (p[:-2] + 2.0 * p[1:-1] + p[2:]) * 0.25
        p = np.pad(img, ((0, 0), (1, 1), (0, 0)), mode="edge")
        img = (p[:, :-2] + 2.0 * p[:, 1:-1] + p[:, 2:]) * 0.25

    edges, weights = [], []
    for dy, dx in ((0, 1), (1, 0), (1, 1), (1, -1)):
        x0, x1 = max(0, -dx), (w - dx if dx > 0 else w)
        a = idx[:h - dy, x0:x1]
        b = idx[dy:, x0 + dx:x1 + dx]
        diff = img[:h - dy, x0:x1] - img[dy:, x0 + dx:x1 + dx]
        edges.append(np.stack([a.ravel(), b.ravel()], 1))
        weights.append(np.sqrt((diff ** 2).sum(-1)).ravel())
    edges = np.concatenate(edges)
    weights = np.concatenate(weights)
    order = np.argsort(weights, kind="stable")
    # Python lists: the loops below run once per edge. The thresholds are
    # taken in float64 from float32 weights, as numpy scalars would give.
    pairs = edges[order].tolist()
    weights = weights[order].tolist()

    parent = list(range(n))
    size = [1] * n
    internal = [0.0] * n  # the largest MST edge inside the component

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:  # path compression
            parent[x], x = root, parent[x]
        return root

    for (a, b), wgt in zip(pairs, weights):
        ra, rb = find(a), find(b)
        if ra == rb:
            continue
        if wgt <= min(internal[ra] + k / size[ra], internal[rb] + k / size[rb]):
            parent[rb] = ra
            size[ra] += size[rb]
            internal[ra] = wgt
    for a, b in pairs:
        ra, rb = find(a), find(b)
        if ra != rb and (size[ra] < min_size or size[rb] < min_size):
            parent[rb] = ra
            size[ra] += size[rb]
    roots = np.fromiter((find(i) for i in range(n)), np.int32, n)
    _, labels = np.unique(roots, return_inverse=True)
    return labels.reshape(h, w).astype(np.int32)


def _region_boxes_and_hierarchy(labels: np.ndarray, img: np.ndarray,
                                max_merges: int) -> np.ndarray:
    """The regions' boxes, then the box of each greedy merge of the two
    adjacent regions most alike (mean-colour closeness + small size), xyxy
    in the downscaled grid. Ties go to the first pair in the adjacency set's
    order, which is built as the JAX package builds it."""
    h, w = labels.shape
    n_reg = int(labels.max()) + 1
    ys, xs = np.mgrid[0:h, 0:w]
    flat = labels.ravel()
    x0 = np.full(n_reg, w, np.float32)
    y0 = np.full(n_reg, h, np.float32)
    x1 = np.zeros(n_reg, np.float32)
    y1 = np.zeros(n_reg, np.float32)
    np.minimum.at(x0, flat, xs.ravel())
    np.minimum.at(y0, flat, ys.ravel())
    np.maximum.at(x1, flat, xs.ravel())
    np.maximum.at(y1, flat, ys.ravel())
    sizes = np.bincount(flat, minlength=n_reg).astype(np.float32)
    colors = np.zeros((n_reg, 3), np.float32)
    for c in range(3):
        colors[:, c] = np.bincount(flat, weights=img[..., c].ravel(), minlength=n_reg)
    colors /= sizes[:, None]

    # region adjacency from horizontal and vertical label changes
    pairs = set()
    for a, b in ((labels[:, :-1], labels[:, 1:]), (labels[:-1], labels[1:])):
        diff = a != b
        for pa, pb in zip(a[diff].ravel(), b[diff].ravel()):
            pairs.add((min(pa, pb), max(pa, pb)))

    boxes = [np.stack([x0, y0, x1 + 1, y1 + 1], 1)]
    total = float(h * w)
    live = {i: (x0[i], y0[i], x1[i], y1[i], sizes[i], colors[i]) for i in range(n_reg)}
    adj = {p for p in pairs}
    for _ in range(max_merges):
        if not adj:
            break
        # selective search's size term plus its colour term, the colour
        # histogram simplified to the mean colour's distance
        best, best_s = None, -1.0
        for a, b in adj:
            if a not in live or b not in live:
                continue
            sa, ca = live[a][4:]
            sb, cb = live[b][4:]
            s = (1.0 - np.linalg.norm(ca - cb) / 442.0) + (1.0 - (sa + sb) / total)
            if s > best_s:
                best_s, best = s, (a, b)
        if best is None:
            break
        a, b = best
        xa0, ya0, xa1, ya1, sa, ca = live.pop(a)
        xb0, yb0, xb1, yb1, sb, cb = live.pop(b)
        m = (min(xa0, xb0), min(ya0, yb0), max(xa1, xb1), max(ya1, yb1),
             sa + sb, (ca * sa + cb * sb) / (sa + sb))
        key = n_reg + len(boxes)
        live[key] = m
        boxes.append(np.array([[m[0], m[1], m[2] + 1, m[3] + 1]], np.float32))
        adj = {((key if p in (a, b) else p), (key if q in (a, b) else q))
               for p, q in adj if (p, q) != (min(a, b), max(a, b))}
        adj = {(min(p, q), max(p, q)) for p, q in adj if p != q}
    return np.concatenate(boxes, 0)


def selective_patch_boxes(image: np.ndarray, rng: np.random.RandomState, res_size: int = 128,
                          max_boxes: int = 256) -> np.ndarray:
    """Class-agnostic proposals [N, 4] float32 xyxy in `image` coordinates
    (reference `selective_search`, `detr_dataset_mapper.py:185-203`): one
    draw of `rng` for the scale, and a permutation where more than
    `max_boxes` remain."""
    h, w = image.shape[:2]
    small = resize_bilinear_pil(image.astype(np.uint8), res_size, res_size).astype(np.float32)
    k = 50.0 + float(rng.rand()) * 100.0  # the reference's base scale, in [50, 150)
    labels = _felzenszwalb(small, k=k * 3.0, min_size=20)
    boxes = _region_boxes_and_hierarchy(labels, small, max_merges=64)
    boxes = boxes / float(res_size) * np.array([w, h, w, h], np.float32)
    boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
    boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)
    # degenerate and duplicate boxes go, then the count is capped
    keep = (boxes[:, 2] - boxes[:, 0] > 1) & (boxes[:, 3] - boxes[:, 1] > 1)
    boxes = np.unique(np.round(boxes[keep], 1), axis=0)
    if len(boxes) > max_boxes:
        boxes = boxes[rng.permutation(len(boxes))[:max_boxes]]
    return boxes.astype(np.float32)


@dataclasses.dataclass
class SelfSupSample:
    """A `Sample` and its self-supervision patch proposals."""

    sample: Sample
    patch_boxes: np.ndarray  # [N, 4] float32 xyxy; empty at eval time


def selfsup_map(sample: Sample, cfg: DataConfig, rng: Optional[np.random.RandomState] = None,
                is_train: bool = True, res_size: int = 128) -> SelfSupSample:
    """The mapper (`SelfSupervisionDetrDatasetMapper.__call__`,
    `detr_dataset_mapper.py:206-257`): the detection augmentation, then at
    train time the proposals of the augmented image; at eval time the
    annotations are dropped and there are no proposals."""
    if is_train:
        assert rng is not None, "training map needs an RNG"
        out = train_transform(sample, cfg, rng)
        return SelfSupSample(sample=out, patch_boxes=selective_patch_boxes(
            out.image, rng, res_size=res_size))
    out = dataclasses.replace(eval_transform(sample, cfg), boxes=np.zeros((0, 4), np.float32),
                              labels=np.zeros((0,), np.int64))
    return SelfSupSample(sample=out, patch_boxes=np.zeros((0, 4), np.float32))
