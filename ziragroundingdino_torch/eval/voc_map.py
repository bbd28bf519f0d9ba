"""Pascal VOC detection AP, the port of the JAX package's `eval/voc_map.py`
(the reference's second evaluator, `evaluation/pascal_voc_evaluation.py`):
per-class AP at IoU 0.5 with the VOC2007 11-point or the VOC2010+ all-points
(area) interpolation, with VOC's "difficult" ground truth.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ziragroundingdino_torch.eval.coco_map import _iou_xyxy


class VocMeanAP:
    def __init__(self, num_classes: int, iou_thr: float = 0.5, use_07_metric: bool = False):
        self.num_classes = num_classes
        self.iou_thr = iou_thr
        self.use_07 = use_07_metric
        self.entries: List = []

    def add(self, image_id, det_boxes, det_scores, det_labels, gt_boxes, gt_labels,
            gt_difficult=None):
        """Boxes xyxy. A 'difficult' ground truth is left out of the
        positives, and a detection whose best overlap is one is neither a TP
        nor an FP (`voc_eval`, reference `pascal_voc_evaluation.py:255-259`)."""
        gb = np.asarray(gt_boxes, np.float32).reshape(-1, 4)
        self.entries.append((
            image_id,
            np.asarray(det_boxes, np.float32).reshape(-1, 4),
            np.asarray(det_scores, np.float32).reshape(-1),
            np.asarray(det_labels, np.int64).reshape(-1),
            gb,
            np.asarray(gt_labels, np.int64).reshape(-1),
            np.asarray(gt_difficult, bool).reshape(-1)
            if gt_difficult is not None else np.zeros((len(gb),), bool),
        ))

    def _ap(self, rec: np.ndarray, prec: np.ndarray) -> float:
        if self.use_07:
            ap = 0.0
            for t in np.arange(0.0, 1.1, 0.1):
                p = prec[rec >= t].max() if (rec >= t).any() else 0.0
                ap += p / 11.0
            return float(ap)
        mrec = np.concatenate(([0.0], rec, [1.0]))
        mpre = np.concatenate(([0.0], prec, [0.0]))
        mpre = np.maximum.accumulate(mpre[::-1])[::-1]  # the precision envelope
        idx = np.where(mrec[1:] != mrec[:-1])[0]
        return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))

    def _class_matches(self, c: int):
        """(scores, matched, skipped, positives) of class `c` over the
        images, each image's detections greedily matched in score order."""
        scores, matched, skipped = [], [], []
        npos = 0
        for _, db, ds, dl, gb, gl, gdiff in self.entries:
            gm = gl == c
            g, diff = gb[gm], gdiff[gm]
            npos += int((~diff).sum())
            d = dl == c
            order = np.argsort(-ds[d], kind="mergesort")
            db_c, ds_c = db[d][order], ds[d][order]
            iou = _iou_xyxy(db_c, g)
            taken = np.zeros(len(g), bool)
            for i in range(len(db_c)):
                scores.append(ds_c[i])
                hit, skip = False, False
                if len(g):
                    j = int(np.argmax(iou[i]))
                    # strict >, as the reference's `ovmax > ovthresh`
                    if iou[i, j] > self.iou_thr and diff[j]:
                        skip = True
                    elif iou[i, j] > self.iou_thr and not taken[j]:
                        taken[j] = hit = True
                matched.append(hit)
                skipped.append(skip)
        return np.asarray(scores), np.asarray(matched, bool), np.asarray(skipped, bool), npos

    def summarize(self) -> Dict[str, float]:
        aps = []
        for c in range(self.num_classes):
            scores, matched, skipped, npos = self._class_matches(c)
            if npos == 0:
                continue
            order = np.argsort(-scores, kind="mergesort")
            m_o, sk_o = matched[order], skipped[order]
            tp = np.cumsum(m_o)
            fp = np.cumsum(~m_o & ~sk_o)
            rec = tp / npos
            prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
            aps.append(self._ap(rec, prec))
        return {
            "mAP": float(np.mean(aps) * 100.0) if aps else float("nan"),
            "per_class_AP": [a * 100.0 for a in aps],
        }
