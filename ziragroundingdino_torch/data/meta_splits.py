"""Few-shot "meta" base/novel splits of COCO, PASCAL VOC and LVIS, the port
of the JAX package's `data/meta_splits.py` (reference `datasets/builtin.py:
297-299`, `meta_coco.py`, `meta_pascal_voc.py`, `meta_lvis.py`). The splits
are derived, not tabled:

* VOC: the three standard novel splits (FsDet), five names each;
* COCO: the 20 VOC-overlapping categories are novel, the other 60 base;
* LVIS: rare categories (1-10 training images) are novel, common (11-100)
  and frequent (>100) base, from the json's `frequency` or `image_count`,
  or recounted from the annotations.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from ziragroundingdino_torch.data.builtin_meta import COCO_CLASSES

VOC_CLASSES: Tuple[str, ...] = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)

VOC_NOVEL_SPLITS: Dict[int, Tuple[str, ...]] = {
    1: ("bird", "bus", "cow", "motorbike", "sofa"),
    2: ("aeroplane", "bottle", "cow", "horse", "sofa"),
    3: ("boat", "cat", "motorbike", "sheep", "sofa"),
}

# VOC name -> COCO name where they differ
_VOC_TO_COCO = {
    "aeroplane": "airplane",
    "diningtable": "dining table",
    "motorbike": "motorcycle",
    "pottedplant": "potted plant",
    "sofa": "couch",
    "tvmonitor": "tv",
}

COCO_NOVEL_CLASSES: Tuple[str, ...] = tuple(_VOC_TO_COCO.get(c, c) for c in VOC_CLASSES)


def _subset(base: Tuple[str, ...], novel: Tuple[str, ...], subset: str,
            all_: Tuple[str, ...]) -> Tuple[str, ...]:
    if subset == "novel":
        return novel
    if subset == "base":
        return base
    if subset == "all":
        return all_
    raise ValueError(subset)


def voc_meta_split(split_id: int, subset: str = "novel") -> Tuple[str, ...]:
    """Class names of VOC few-shot split `split_id` in {1, 2, 3}; "all" is
    base then novel."""
    novel = VOC_NOVEL_SPLITS[split_id]
    base = tuple(c for c in VOC_CLASSES if c not in novel)
    return _subset(base, novel, subset, base + novel)


def coco_meta_split(subset: str = "base") -> Tuple[str, ...]:
    """The 60/20 base/novel COCO few-shot split, in contiguous COCO order."""
    novel = set(COCO_NOVEL_CLASSES)
    assert novel <= set(COCO_CLASSES), novel - set(COCO_CLASSES)
    return _subset(tuple(c for c in COCO_CLASSES if c not in novel),
                   tuple(c for c in COCO_CLASSES if c in novel), subset, tuple(COCO_CLASSES))


def lvis_frequency_bands(categories: Sequence[dict],
                         annotations: Optional[Sequence[dict]] = None) -> List[str]:
    """'r'/'c'/'f' per category: the json's `frequency`, else its
    `image_count`, else the distinct images of `annotations` (rare 1-10,
    common 11-100, frequent above)."""
    counts = None
    if annotations is not None:
        counts = {}
        for a in annotations:
            counts.setdefault(a["category_id"], set()).add(a["image_id"])
    bands = []
    for c in categories:
        if "frequency" in c:
            bands.append(c["frequency"])
            continue
        n = c.get("image_count")
        if n is None:
            if counts is None:
                raise ValueError(f"category {c.get('id')} has neither frequency nor "
                                 "image_count, and no annotations were provided")
            n = len(counts.get(c["id"], ()))
        bands.append("r" if n <= 10 else ("c" if n <= 100 else "f"))
    return bands


def lvis_meta_split(categories: Sequence[dict], subset: str = "base",
                    annotations: Optional[Sequence[dict]] = None) -> Tuple[str, ...]:
    """LVIS few-shot meta split: novel = rare, base = common + frequent."""
    keep = {"novel": {"r"}, "base": {"c", "f"}, "all": {"r", "c", "f"}}.get(subset)
    if keep is None:
        raise ValueError(subset)
    bands = lvis_frequency_bands(categories, annotations)
    return tuple(c.get("name", str(c.get("id"))) for c, b in zip(categories, bands) if b in keep)


def filter_dataset_to_classes(ds, class_names: Sequence[str], filter_empty: bool = False):
    """A `CocoDataset` restricted to `class_names`, labels in their order;
    with `filter_empty`, images left without annotations are dropped."""
    name_to_new = {n: i for i, n in enumerate(class_names)}
    missing = set(class_names) - set(ds.category_names)
    if missing:
        raise ValueError(f"classes not in dataset: {sorted(missing)}")
    kept_json_ids = {jid: name_to_new[ds.category_names[old]]
                     for jid, old in ds.cat_id_to_contiguous.items()
                     if ds.category_names[old] in name_to_new}
    anns_by_image = {img_id: [a for a in anns if a["category_id"] in kept_json_ids]
                     for img_id, anns in ds.anns_by_image.items()}
    images = ds.images
    if filter_empty:
        images = [im for im in images if anns_by_image.get(im["id"])]
    return dataclasses.replace(ds, category_names=list(class_names),
                               cat_id_to_contiguous=kept_json_ids, images=images,
                               anns_by_image=anns_by_image)
