"""COCO-json dataset (no pycocotools / detectron2 dependency), the port's
copy of the JAX package's `data/coco.py`; images are decoded by
`data.transforms.read_image` (PPM without PIL).

Capability parity with the reference's dataset registration + mapper chain:
COCO-json instances loading (`datasets/builtin.py:297-299` +
`config/configs/common/data/odinw/aquarium.py:19-33` register_coco_instances)
and the DETR mapper's caption construction
(`datasets/detr_dataset_mapper.py:85-137`: captions =
".".join(category_names) + "."). ODinW sub-datasets are plain COCO jsons, so
one loader covers COCO + all 13/35 ODinW tasks; few-shot variants just point
at smaller jsons.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from ziragroundingdino_torch.data import transforms
from ziragroundingdino_torch.data.transforms import Sample


@dataclass
class CocoDataset:
    """Parsed COCO instances json + image root."""

    image_root: str
    # contiguous category ids 0..C-1 in json-order (the detectron2
    # thing_dataset_id_to_contiguous_id mapping)
    category_names: List[str] = field(default_factory=list)
    cat_id_to_contiguous: Dict[int, int] = field(default_factory=dict)
    images: List[dict] = field(default_factory=list)  # coco image dicts
    anns_by_image: Dict[int, List[dict]] = field(default_factory=dict)
    # iscrowd annotations, kept for evaluation-time ignore matching only
    crowd_by_image: Dict[int, List[dict]] = field(default_factory=dict)

    @classmethod
    def from_json(
        cls, json_file: str, image_root: str, filter_empty: bool = False
    ) -> "CocoDataset":
        with open(json_file) as f:
            coco = json.load(f)
        cats = sorted(coco.get("categories", []), key=lambda c: c["id"])
        names = [c["name"] for c in cats]
        cat_map = {c["id"]: i for i, c in enumerate(cats)}
        anns_by_image: Dict[int, List[dict]] = {}
        crowd_by_image: Dict[int, List[dict]] = {}
        for a in coco.get("annotations", []):
            if a.get("iscrowd", 0):
                # crowds never train (the reference mapper drops them) but
                # evaluation must IGNORE-match them like pycocotools, not
                # count their detections as false positives
                crowd_by_image.setdefault(a["image_id"], []).append(a)
                continue
            anns_by_image.setdefault(a["image_id"], []).append(a)
        images = coco.get("images", [])
        if filter_empty:
            images = [im for im in images if anns_by_image.get(im["id"])]
        return cls(
            image_root=image_root, category_names=names,
            cat_id_to_contiguous=cat_map, images=images,
            anns_by_image=anns_by_image, crowd_by_image=crowd_by_image,
        )

    def __len__(self) -> int:
        return len(self.images)

    @property
    def caption(self) -> str:
        """`detr_dataset_mapper.py:111-113`."""
        return ".".join(self.category_names) + "."

    def load_sample(self, idx: int, read_image: bool = True) -> Sample:
        im = self.images[idx]
        anns = self.anns_by_image.get(im["id"], [])
        boxes = np.asarray(
            [a["bbox"] for a in anns], np.float32
        ).reshape(-1, 4)
        # coco xywh -> xyxy
        if boxes.size:
            boxes[:, 2:] += boxes[:, :2]
        labels = np.asarray(
            [self.cat_id_to_contiguous[a["category_id"]] for a in anns], np.int64
        )
        if read_image:
            img = transforms.read_image(os.path.join(self.image_root, im["file_name"]))
        else:
            img = np.zeros((im["height"], im["width"], 3), np.uint8)
        crowd_boxes, crowd_labels = self.crowd_annotations(im["id"])
        areas = np.asarray(
            [a.get("area", 0.0) for a in anns], np.float32
        )
        return Sample(
            image=img, boxes=boxes, labels=labels,
            orig_size=(im["height"], im["width"]), image_id=im["id"],
            crowd_boxes=crowd_boxes, crowd_labels=crowd_labels,
            gt_areas=areas,
        )

    def crowd_annotations(self, image_id: int):
        """(boxes xyxy [M,4], labels [M]) of iscrowd annotations — evaluation
        ignore-regions (pycocotools semantics)."""
        anns = self.crowd_by_image.get(image_id, [])
        boxes = np.asarray([a["bbox"] for a in anns], np.float32).reshape(-1, 4)
        if boxes.size:
            boxes[:, 2:] += boxes[:, :2]
        labels = np.asarray(
            [self.cat_id_to_contiguous[a["category_id"]] for a in anns], np.int64
        )
        return boxes, labels
