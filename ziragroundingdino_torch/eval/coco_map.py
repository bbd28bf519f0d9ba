"""COCO-style bbox mAP in pure numpy (pycocotools is not in the image): the
port's copy of the JAX package's `eval/coco_map.py`, line for line.

Implements the COCOeval bbox protocol the reference relies on
(`evaluation/coco_evaluation.py:100-205,305` -> pycocotools COCOeval):
IoU thresholds 0.50:0.95:0.05, 101 recall points, area ranges
all/small/medium/large, maxDets (1, 10, 100), greedy per-category matching
of score-sorted detections, iscrowd ignore-matching (dt-area IoU, crowds
absorb any number of detections, excluded from recall). Produces
the standard 12 metrics; `AP` is the headline number averaged by
`train_multidatasets.py:552-559`. Per-category AP mirrors the table the
reference prints at `evaluation/coco_evaluation.py:205-269`.

The matcher is vectorized: (image, category) pairs are processed in padded
chunks, all 10 IoU thresholds simultaneously, with one python loop over
det rank only (greedy matching is sequential in the detection order by
definition). pycocotools semantics — non-ignored-gt preference, last-wins
IoU tie-breaking, the `thr - 1e-10` bar, area-based gt/dt ignores — are
encoded in a single argmax per rank (see `_greedy_match`). A 5k-image x
80-class eval accumulates in seconds.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
AREA_NAMES = ("all", "small", "medium", "large")


def _iou_xyxy(d: np.ndarray, g: np.ndarray) -> np.ndarray:
    """[D, G] IoU."""
    if d.size == 0 or g.size == 0:
        return np.zeros((len(d), len(g)), np.float32)
    lt = np.maximum(d[:, None, :2], g[None, :, :2])
    rb = np.minimum(d[:, None, 2:], g[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    ad = (d[:, 2] - d[:, 0]) * (d[:, 3] - d[:, 1])
    ag = (g[:, 2] - g[:, 0]) * (g[:, 3] - g[:, 1])
    union = ad[:, None] + ag[None, :] - inter
    return np.where(union > 0, inter / union, 0.0).astype(np.float32)


def _greedy_match(
    iou: np.ndarray,      # [N, D, G] zero-padded
    g_ign: np.ndarray,    # [N, G] bool, True = ignored gt (padding rows True)
    g_valid: np.ndarray,  # [N, G] bool, True = real (non-padding) gt
    g_crowd: Optional[np.ndarray] = None,  # [N, G] bool: crowd gts stay
                                           # matchable by multiple dets
) -> np.ndarray:
    """pycocotools greedy matching, vectorized over pairs x IoU thresholds.

    For each detection rank r (score order), each (pair, threshold) picks
    the available gt maximizing (iou, non-ignored preference) with last-wins
    tie-breaking, subject to iou >= thr - 1e-10 — exactly the scan at
    pycocotools cocoeval.evaluateImg (the reference's matcher through
    `evaluation/coco_evaluation.py:305`). Returns matched gt index or -1,
    shape [N, T, D].
    """
    n, d, g = iou.shape
    t = len(IOU_THRS)
    if d == 0 or g == 0:
        return np.full((n, t, d), -1, np.int64)
    avail = np.broadcast_to(g_valid[:, None, :], (n, t, g)).copy()
    # non-ignored gts dominate any ignored gt (iou <= 1 < 10): the
    # sequential scan's "break on entering the ignored tail once a real
    # match exists" is equivalent to an absolute preference.
    pref = np.where(g_ign, 0.0, 10.0).astype(np.float32)[:, None, :]  # [N,1,G]
    thr = (IOU_THRS - 1e-10).astype(np.float32).reshape(1, t, 1)
    out = np.full((n, t, d), -1, np.int64)
    taken = np.zeros((n, t, g), bool)
    for r in range(d):
        row = iou[:, r, :][:, None, :]  # [N,1,G]
        ok = avail & (row >= thr)
        score = np.where(ok, row + pref, -np.inf)  # [N,T,G]
        # last-wins argmax (sequential scan updates on iou == best)
        best = g - 1 - np.argmax(score[..., ::-1], axis=-1)  # [N,T]
        has = np.take_along_axis(score, best[..., None], -1)[..., 0] > -np.inf
        out[:, :, r] = np.where(has, best, -1)
        taken[:] = False
        np.put_along_axis(taken, best[..., None], has[..., None], -1)
        if g_crowd is not None:
            # pycocotools: a crowd gt may absorb any number of detections
            # (`if gtm[tind, gind] > 0 and not iscrowd[gind]: continue`)
            taken &= ~g_crowd[:, None, :]
        avail &= ~taken
    return out


class CocoMeanAP:
    """Accumulates detections + ground truth, then computes COCO metrics.

    add(image_id, det_boxes [D,4] xyxy, det_scores [D], det_labels [D],
        gt_boxes [G,4] xyxy, gt_labels [G])
    """

    #: maxDets used for the AR@k metrics (pycocotools params.maxDets)
    recall_max_dets: Tuple[int, ...] = (1, 10, 100)

    def __init__(self, num_classes: int, max_dets: int = 100):
        self.num_classes = num_classes
        self.max_dets = max_dets
        # AR@k labels track the actual det cap (pycocotools params.maxDets
        # is (1, 10, maxDet)); a non-default cap must not masquerade as
        # "AR@100"
        self.recall_max_dets = tuple(
            k for k in self.recall_max_dets if k < max_dets
        ) + (max_dets,)
        self.entries: List[Tuple] = []
        self._cache = None

    def add(self, image_id, det_boxes, det_scores, det_labels, gt_boxes,
            gt_labels, crowd_boxes=None, crowd_labels=None, gt_areas=None):
        """crowd_boxes/labels: iscrowd regions, ignore-matched like
        pycocotools (dt-area IoU, never counted in recall, absorb any number
        of detections). gt_areas: the annotation "area" field (segmentation
        area) pycocotools uses for the s/m/l gt ranges; entries <= 0 fall
        back to the box area."""
        gb = np.asarray(gt_boxes, np.float32).reshape(-1, 4)
        ga = (np.asarray(gt_areas, np.float32).reshape(-1)
              if gt_areas is not None else np.zeros((len(gb),), np.float32))
        self.entries.append((
            image_id,
            np.asarray(det_boxes, np.float32).reshape(-1, 4),
            np.asarray(det_scores, np.float32).reshape(-1),
            np.asarray(det_labels, np.int64).reshape(-1),
            gb,
            np.asarray(gt_labels, np.int64).reshape(-1),
            np.asarray(crowd_boxes, np.float32).reshape(-1, 4)
            if crowd_boxes is not None else np.zeros((0, 4), np.float32),
            np.asarray(crowd_labels, np.int64).reshape(-1)
            if crowd_labels is not None else np.zeros((0,), np.int64),
            ga,
        ))
        self._cache = None

    # ------------------------------------------------------------------
    # hooks for federated protocols (LVIS overrides these)
    def _include_pair(self, img_id, c, has_gt: bool, has_dt: bool) -> bool:
        return True

    def _ignore_unmatched_dets(self, img_id, c) -> bool:
        return False

    # ------------------------------------------------------------------
    def _build_pairs(self):
        """Group (image, category) pairs with score-sorted, max_dets-trimmed
        detections. Returns a list of dict records."""
        pairs = []
        for img_id, db, ds, dl, gb, gl, cb, cl, ga in self.entries:
            cats = np.union1d(np.union1d(np.unique(dl), np.unique(gl)), np.unique(cl))
            cats = cats[(cats >= 0) & (cats < self.num_classes)]
            for c in cats:
                dm = dl == c
                gm = gl == c
                cm = cl == c
                has_dt, has_gt = bool(dm.any()), bool(gm.any())
                if not self._include_pair(img_id, int(c), has_gt, has_dt):
                    continue
                dbc, dsc = db[dm], ds[dm]
                order = np.argsort(-dsc, kind="mergesort")[: self.max_dets]
                # crowd gts go AFTER the real gts (the ignored tail, like
                # pycocotools' ignored-last sort)
                pairs.append({
                    "img": img_id, "cat": int(c),
                    "db": dbc[order], "ds": dsc[order],
                    "gb": np.concatenate([gb[gm], cb[cm]], axis=0),
                    "ga": np.concatenate(
                        [ga[gm], np.zeros(int(cm.sum()), np.float32)]),
                    "n_crowd": int(cm.sum()),
                    "ign_unmatched": self._ignore_unmatched_dets(img_id, int(c)),
                })
        return pairs

    def _evaluate(self):
        """Match every (image, category) pair for every area range.

        Produces flat per-detection arrays (score-sorted within pair):
          det_score [M], det_cat [M], det_rank [M],
          matched  {area: [T, M] bool},
          ignored  {area: [T, M] bool},
          npig     {area: [C] int}
        cached until the next add().
        """
        if self._cache is not None:
            return self._cache
        t = len(IOU_THRS)
        pairs = self._build_pairs()
        # order pairs by (cat, then insertion) so per-class dets are
        # contiguous; within a class, pair order == image insertion order
        # (pycocotools concatenates per-image in list order)
        pairs.sort(key=lambda p: p["cat"])
        m_total = sum(len(p["ds"]) for p in pairs)
        det_score = np.zeros(m_total, np.float32)
        det_cat = np.zeros(m_total, np.int64)
        det_rank = np.zeros(m_total, np.int64)
        matched = {a: np.zeros((t, m_total), bool) for a in AREA_NAMES}
        ignored = {a: np.zeros((t, m_total), bool) for a in AREA_NAMES}
        npig = {a: np.zeros(self.num_classes, np.int64) for a in AREA_NAMES}

        # chunk pairs (sorted by det count to reduce rank padding)
        chunk_order = sorted(range(len(pairs)), key=lambda i: len(pairs[i]["ds"]))
        offsets = np.cumsum([0] + [len(p["ds"]) for p in pairs])
        chunk_size = 2048
        for s in range(0, len(chunk_order), chunk_size):
            idxs = chunk_order[s:s + chunk_size]
            chunk = [pairs[i] for i in idxs]
            n = len(chunk)
            d_max = max((len(p["ds"]) for p in chunk), default=0)
            g_max = max((len(p["gb"]) for p in chunk), default=0)
            db = np.zeros((n, d_max, 4), np.float32)
            gb = np.zeros((n, g_max, 4), np.float32)
            ga_ann = np.zeros((n, g_max), np.float32)
            n_dt = np.zeros(n, np.int64)
            n_gt = np.zeros(n, np.int64)
            for j, p in enumerate(chunk):
                n_dt[j] = len(p["ds"])
                n_gt[j] = len(p["gb"])
                db[j, : n_dt[j]] = p["db"]
                gb[j, : n_gt[j]] = p["gb"]
                ga_ann[j, : n_gt[j]] = p["ga"]
            # padded det rows need no mask: their IoU row is all zeros (zero
            # boxes) so they never match, and the flat scatter below copies
            # only the first n_dt columns per pair
            g_valid = np.arange(g_max)[None, :] < n_gt[:, None]
            # crowd gts occupy the last n_crowd columns of each pair
            n_crowd = np.asarray([p["n_crowd"] for p in chunk], np.int64)
            g_crowd = g_valid & (
                np.arange(g_max)[None, :] >= (n_gt - n_crowd)[:, None]
            )
            # IoU once per chunk, shared across area ranges
            if d_max and g_max:
                lt = np.maximum(db[:, :, None, :2], gb[:, None, :, :2])
                rb = np.minimum(db[:, :, None, 2:], gb[:, None, :, 2:])
                wh = np.clip(rb - lt, 0, None)
                inter = wh[..., 0] * wh[..., 1]
                ad = (db[:, :, 2] - db[:, :, 0]) * (db[:, :, 3] - db[:, :, 1])
                ag = (gb[:, :, 2] - gb[:, :, 0]) * (gb[:, :, 3] - gb[:, :, 1])
                union = ad[:, :, None] + ag[:, None, :] - inter
                # crowd columns: pycocotools iscrowd IoU divides by the DT
                # area only (maskUtils.iou(..., iscrowd=1))
                union = np.where(
                    g_crowd[:, None, :],
                    np.broadcast_to(ad[:, :, None], union.shape), union,
                )
                with np.errstate(invalid="ignore", divide="ignore"):
                    iou = np.where(union > 0, inter / union, 0.0).astype(np.float32)
                iou = np.where(g_valid[:, None, :], iou, 0.0)
            else:
                iou = np.zeros((n, d_max, g_max), np.float32)
                ag = (gb[:, :, 2] - gb[:, :, 0]) * (gb[:, :, 3] - gb[:, :, 1])
                ad = (db[:, :, 2] - db[:, :, 0]) * (db[:, :, 3] - db[:, :, 1])
            # pycocotools ranges gt by the annotation "area" (segmentation
            # area) when present; 0 entries (crowds appended, datasets
            # without the field) keep the box area
            ag = np.where(ga_ann > 0, ga_ann, ag)
            ign_unmatched = np.asarray([p["ign_unmatched"] for p in chunk], bool)

            for area in AREA_NAMES:
                lo, hi = AREA_RNG[area]
                g_ign = (~g_valid) | (ag < lo) | (ag > hi) | g_crowd
                d_out = (ad < lo) | (ad > hi)
                dt_gt = _greedy_match(iou, g_ign, g_valid, g_crowd)  # [N,T,D]
                is_matched = dt_gt >= 0
                m_gt_ign = np.take_along_axis(
                    np.broadcast_to(g_ign[:, None, :], (n, t, max(g_max, 1))),
                    np.clip(dt_gt, 0, None), axis=-1,
                ) if g_max else np.zeros((n, t, d_max), bool)
                dt_ign = np.where(is_matched, m_gt_ign, d_out[:, None, :])
                if ign_unmatched.any():
                    dt_ign |= (~is_matched) & ign_unmatched[:, None, None]
                # scatter into the flat arrays
                for j, pi in enumerate(idxs):
                    o, nd = offsets[pi], n_dt[j]
                    matched[area][:, o:o + nd] = is_matched[j, :, :nd]
                    ignored[area][:, o:o + nd] = dt_ign[j, :, :nd]
                    npig[area][pairs[pi]["cat"]] += int((~g_ign[j] & g_valid[j]).sum())

            for j, pi in enumerate(idxs):
                o, nd = offsets[pi], n_dt[j]
                det_score[o:o + nd] = pairs[pi]["ds"]
                det_cat[o:o + nd] = pairs[pi]["cat"]
                det_rank[o:o + nd] = np.arange(nd)

        # per-class contiguous slices (pairs sorted by cat; offsets ordered)
        cls_slices = {}
        start = 0
        for c in range(self.num_classes):
            end = start
            while end < len(pairs) and pairs[end]["cat"] == c:
                end += 1
            cls_slices[c] = (offsets[start], offsets[end] if end < len(pairs) else m_total)
            start = end
        self._cache = dict(
            det_score=det_score, det_cat=det_cat, det_rank=det_rank,
            matched=matched, ignored=ignored, npig=npig, cls_slices=cls_slices,
        )
        return self._cache

    # ------------------------------------------------------------------
    def _accumulate(self, area_name: str, max_det: Optional[int] = None):
        """Returns (ap [T, C], ar [T, C]) with nan for absent categories."""
        ev = self._evaluate()
        max_det = max_det or self.max_dets
        t = len(IOU_THRS)
        ap = np.full((t, self.num_classes), np.nan)
        ar = np.full((t, self.num_classes), np.nan)
        m_area = ev["matched"][area_name]
        i_area = ev["ignored"][area_name]
        for c in range(self.num_classes):
            np_c = int(ev["npig"][area_name][c])
            if np_c == 0:
                continue
            lo, hi = ev["cls_slices"][c]
            sel = slice(lo, hi)
            keep = ev["det_rank"][sel] < max_det
            s = ev["det_score"][sel][keep]
            order = np.argsort(-s, kind="mergesort")
            m = m_area[:, sel][:, keep][:, order]
            ig = i_area[:, sel][:, keep][:, order]
            tp = np.cumsum(m & ~ig, axis=1, dtype=np.float64)
            fp = np.cumsum(~m & ~ig, axis=1, dtype=np.float64)
            rc = tp / np_c
            pr = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
            ar[:, c] = rc[:, -1] if rc.shape[1] else 0.0
            # precision envelope (monotone non-increasing from the right)
            env = np.maximum.accumulate(pr[:, ::-1], axis=1)[:, ::-1]
            for ti in range(t):
                inds = np.searchsorted(rc[ti], REC_THRS, side="left")
                valid = inds < env.shape[1]
                q = np.zeros(len(REC_THRS))
                q[valid] = env[ti][inds[valid]]
                ap[ti, c] = q.mean()
        return ap, ar

    # ------------------------------------------------------------------
    def per_category_ap(self) -> np.ndarray:
        """Per-category AP (area=all, IoU-averaged), nan for absent
        categories — the table the reference prints per eval
        (`evaluation/coco_evaluation.py:205-269`)."""
        ap_all, _ = self._accumulate("all")
        with np.errstate(invalid="ignore"):
            return np.nanmean(ap_all, axis=0) * 100.0

    def per_category_table(self, class_names: Optional[Sequence[str]] = None) -> str:
        ap = self.per_category_ap()
        names = class_names or [str(i) for i in range(self.num_classes)]
        rows = [
            f"{names[i][:24]:<24} {ap[i]:6.1f}" if np.isfinite(ap[i])
            else f"{names[i][:24]:<24}    nan"
            for i in range(self.num_classes)
        ]
        header = f"{'category':<24} {'AP':>6}"
        return "\n".join([header, "-" * len(header)] + rows)

    def summarize(self) -> Dict[str, float]:
        ap_all, ar_all = self._accumulate("all")

        def mean(x):
            return float(np.nanmean(x)) * 100.0 if np.isfinite(x).any() else float("nan")

        res = {
            "AP": mean(ap_all),
            "AP50": mean(ap_all[0]),
            "AP75": mean(ap_all[5]),
        }
        for k in self.recall_max_dets:
            if k == self.max_dets:
                res[f"AR@{k}"] = mean(ar_all)
            else:
                _, ar_k = self._accumulate("all", max_det=k)
                res[f"AR@{k}"] = mean(ar_k)
        for name in ("small", "medium", "large"):
            ap, ar = self._accumulate(name)
            res[f"AP{name[0]}"] = mean(ap)
            res[f"AR{name[0]}"] = mean(ar)
        return res
