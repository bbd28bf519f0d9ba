"""Class-incremental dataset splits, the port of the JAX package's
`data/incremental_voc.py` (reference `datasets/incremental_voc.py:103` and
`datasets/coco_wo_voc.py:34-271`): class-subset filtering of any
`CocoDataset`, the VOC incremental protocols (10+10, 15+5, 19+1) and COCO
without the 20 VOC classes.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from ziragroundingdino_torch.data.coco import CocoDataset

VOC_CLASSES: List[str] = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]

INCREMENTAL_PROTOCOLS: Dict[str, Tuple[int, int]] = {
    "10+10": (10, 10),
    "15+5": (15, 5),
    "19+1": (19, 1),
}

# the COCO names of the 20 VOC classes
VOC_IN_COCO = frozenset({
    "airplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "dining table", "dog", "horse", "motorcycle",
    "person", "potted plant", "sheep", "couch", "train", "tv",
})


def incremental_splits(classes: Sequence[str],
                       protocol: str = "10+10") -> Tuple[List[str], List[str]]:
    """(base classes, incremental classes) of `protocol`, in `classes` order."""
    base_n, inc_n = INCREMENTAL_PROTOCOLS[protocol]
    assert base_n + inc_n <= len(classes)
    return list(classes[:base_n]), list(classes[base_n:base_n + inc_n])


def filter_classes(ds: CocoDataset, keep: Sequence[str], invert: bool = False) -> CocoDataset:
    """The dataset restricted to the classes `keep` (with `invert`, to the
    others): categories and annotations are filtered, images left without an
    annotation dropped, contiguous ids reassigned in the dataset's order."""
    keep_set = set(keep)
    kept_names = [n for n in ds.category_names if (n in keep_set) != invert]
    name_to_new = {n: i for i, n in enumerate(kept_names)}
    old_to_new: Dict[int, int] = {}
    for old_id, contig in ds.cat_id_to_contiguous.items():
        name = ds.category_names[contig]
        if name in name_to_new:
            old_to_new[old_id] = name_to_new[name]
    anns_by_image = {}
    for img_id, anns in ds.anns_by_image.items():
        kept = [a for a in anns if a["category_id"] in old_to_new]
        if kept:
            anns_by_image[img_id] = kept
    images = [im for im in ds.images if im["id"] in anns_by_image]
    return CocoDataset(image_root=ds.image_root, category_names=kept_names,
                       cat_id_to_contiguous=old_to_new, images=images,
                       anns_by_image=anns_by_image)


def coco_without_voc(ds: CocoDataset) -> CocoDataset:
    """`coco_wo_voc.py`: COCO without the categories VOC shares with it."""
    return filter_classes(ds, VOC_IN_COCO, invert=True)
