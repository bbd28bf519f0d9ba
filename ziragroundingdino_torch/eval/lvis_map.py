"""LVIS federated evaluation, the port of the JAX package's
`eval/lvis_map.py` (reference `evaluation/lvis_evaluation.py`, the LVIS
API). The federated protocol differs from COCO's:

* a category that an image neither has ground truth of nor lists in its
  `neg_category_ids` is unverified there, and its detections are ignored;
  on a verified negative they are false positives;
* where an image's annotations of a category are not exhaustive, its
  unmatched detections are ignored (they may be unannotated objects);
* maxDets is 300, with no per-category cap.

`LvisMeanAP` puts these rules into `CocoMeanAP`'s matcher through its
`_include_pair` / `_ignore_unmatched_dets` hooks, and reports APr/APc/APf
when the categories' frequencies are given.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Set

import numpy as np

from ziragroundingdino_torch.eval.coco_map import CocoMeanAP


class LvisMeanAP(CocoMeanAP):
    def __init__(self, num_classes: int, max_dets: int = 300,
                 category_frequency: Optional[Sequence[str]] = None):  # 'r'/'c'/'f' per class
        super().__init__(num_classes=num_classes, max_dets=max_dets)
        self.recall_max_dets = (max_dets,)
        self.category_frequency = category_frequency
        # per image: the verified-absent categories, and the not exhaustively
        # annotated ones
        self._neg: Dict[int, Set[int]] = {}
        self._not_exhaustive: Dict[int, Set[int]] = {}

    def add_image_meta(self, image_id, neg_category_ids: Sequence[int],
                       not_exhaustive_category_ids: Sequence[int] = ()):
        self._neg[image_id] = set(neg_category_ids)
        self._not_exhaustive[image_id] = set(not_exhaustive_category_ids)
        self._cache = None

    def _include_pair(self, img_id, c, has_gt: bool, has_dt: bool) -> bool:
        return has_gt or c in self._neg.get(img_id, set())

    def _ignore_unmatched_dets(self, img_id, c) -> bool:
        return c in self._not_exhaustive.get(img_id, set())

    def summarize(self) -> Dict[str, float]:
        res = super().summarize()
        if self.category_frequency is not None:
            ap_all, _ = self._accumulate("all")
            with np.errstate(invalid="ignore"):
                per_class = np.nanmean(ap_all, axis=0)
            for band, key in (("r", "APr"), ("c", "APc"), ("f", "APf")):
                idx = [i for i, f in enumerate(self.category_frequency) if f == band]
                vals = per_class[idx] if idx else np.asarray([np.nan])
                res[key] = (float(np.nanmean(vals)) * 100.0 if np.isfinite(vals).any()
                            else float("nan"))
        return res
