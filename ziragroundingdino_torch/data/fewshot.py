"""Few-shot dataset subsampling, the port of the JAX package's
`data/fewshot.py`: the ODinW `fewshot_train_shot{K}_seed{S}.json` files
(reference `odinw_1shot/aquarium.py:21`) and the meta few-shot COCO/LVIS
splits are K-shots-per-class subsets of a `CocoDataset`; `fewshot_subset`
draws one and `write_fewshot_json` writes it under the reference's file name
(`data/odinw.py` reads it for `--shot Kshot`).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from ziragroundingdino_torch.data.coco import CocoDataset


def fewshot_subset(ds: CocoDataset, shots: int, seed: int = 3) -> CocoDataset:
    """K annotations per class, greedy over the images in a seeded shuffle
    (the GLIP generator's rule): whole images are kept, and an image is
    taken while one of its classes still has fewer than K annotations."""
    rng = np.random.RandomState(seed)
    order = rng.permutation(len(ds.images))
    counts: Dict[int, int] = {i: 0 for i in range(len(ds.category_names))}
    keep_images: List[dict] = []
    anns_by_image: Dict[int, List[dict]] = {}
    for oi in order:
        im = ds.images[int(oi)]
        anns = ds.anns_by_image.get(im["id"], [])
        if not anns:
            continue
        cats = [ds.cat_id_to_contiguous[a["category_id"]] for a in anns]
        if all(counts[c] >= shots for c in set(cats)):
            continue
        keep_images.append(im)
        anns_by_image[im["id"]] = anns
        for c in cats:
            counts[c] += 1
        if all(v >= shots for v in counts.values()):
            break
    return CocoDataset(image_root=ds.image_root, category_names=list(ds.category_names),
                       cat_id_to_contiguous=dict(ds.cat_id_to_contiguous), images=keep_images,
                       anns_by_image=anns_by_image)


def write_fewshot_json(ds: CocoDataset, out_dir: str, shots: int, seed: int = 3) -> str:
    """Writes `fewshot_subset(ds, shots, seed)` as
    `<out_dir>/fewshot_train_shot{K}_seed{S}.json`; returns its path."""
    sub = fewshot_subset(ds, shots, seed)
    contig_to_cat = {v: k for k, v in sub.cat_id_to_contiguous.items()}
    js = {
        "images": sub.images,
        "annotations": [a for anns in sub.anns_by_image.values() for a in anns],
        "categories": [{"id": contig_to_cat[i], "name": n}
                       for i, n in enumerate(sub.category_names)],
    }
    path = os.path.join(out_dir, f"fewshot_train_shot{shots}_seed{seed}.json")
    with open(path, "w") as f:
        json.dump(js, f)
    return path
