"""Synthetic ODinW-style tasks on disk, for smoke runs and tests: ODinW,
COCO and bert-base's vocabulary are not in the repository, so the lifecycle
is driven on seeded COCO-format splits of random PPM images with seeded
boxes, laid out where `data.odinw` looks for the named task."""

from __future__ import annotations

import json
import os
from typing import Dict, Sequence, Tuple

import numpy as np

from ziragroundingdino_torch.data.odinw import ANNOS, ODINW_PATHS


def write_ppm(path: str, image: np.ndarray) -> None:
    """[H, W, 3] uint8 -> binary PPM (P6)."""
    h, w = image.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(image, np.uint8).tobytes())


def write_coco_split(split_dir: str, classes: Sequence[str], n_images: int,
                     size: Tuple[int, int], seed: int, boxes_per_image: int = 3) -> str:
    """`n_images` random images of `size` (h, w) as PPM in `split_dir`, each
    with `boxes_per_image` seeded boxes of random classes, and their COCO
    json (`ANNOS`); returns the json's path."""
    os.makedirs(split_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    h, w = size
    images, anns = [], []
    for i in range(n_images):
        name = f"{i}.ppm"
        write_ppm(os.path.join(split_dir, name), rng.randint(0, 256, (h, w, 3), dtype=np.uint8))
        images.append({"id": i + 1, "file_name": name, "height": h, "width": w})
        for _ in range(boxes_per_image):
            bw, bh = rng.uniform(0.1, 0.5) * w, rng.uniform(0.1, 0.5) * h
            x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": int(rng.randint(len(classes))) + 1,
                         "bbox": [float(x), float(y), float(bw), float(bh)],
                         "area": float(bw * bh), "iscrowd": 0})
    path = os.path.join(split_dir, ANNOS)
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": i + 1, "name": n} for i, n in enumerate(classes)]}, f)
    return path


def write_odinw_task(datasets_root: str, name: str, classes: Sequence[str], n_train: int,
                     n_test: int, size: Tuple[int, int], seed: int) -> None:
    """Train and test splits of the ODinW task `name` (full-shot layout)."""
    sub, train_split, test_split = ODINW_PATHS[name]
    base = os.path.join(datasets_root, sub)
    write_coco_split(os.path.join(base, train_split), classes, n_train, size, seed)
    write_coco_split(os.path.join(base, test_split), classes, n_test, size, seed + 1)


def write_vocab(path: str, vocab: Dict[str, int]) -> None:
    """A vocab.txt: one piece per line, in id order."""
    with open(path, "w") as f:
        f.write("\n".join(sorted(vocab, key=vocab.get)) + "\n")
