"""The one traffic generator: it reads a mix's parameters
(`benchmark/traffic/<name>.json`) and makes a run's inputs from `--seed`.

Every seed gets the same work in another order: the sizes, the label counts
and the grouping of images into requests or batches are fixed by the mix;
the seed draws the order, the category names, the boxes and the pixels. A
photo's pixels come from a generator on the run's device.

Serving (`"kind": "serve"`): `tasks`, each with its label count and its
photo sizes `[h, w]`; every (task, size) pair is one image of the cycle.
Landscape images (w >= h) and portrait ones form requests of `batch`
consecutive images apart, so that a request's images share an orientation
as an aspect-grouping client sends them; the seed permutes the requests. A
short cycle keeps the mix of a window steady.

Training (`"kind": "train"`): `batches` batches of `batch` images. Image i
has the photo aspect i // (#short sides) mod (#aspects), the long side
i mod (#long sides), the training short side i mod (#short sides) (resized
as detectron2's ResizeShortestEdge to at most `max_size`), and label count
counts[i mod (#counts)], each label with `boxes_per_label` boxes; the seed
permutes the batches. Its photos are landscape, `long_side` x `aspect`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference.data import shortest_edge_size


@dataclass
class Request:
    images: List[np.ndarray]  # uint8 [h, w, 3], original size
    labels: List[List[str]]  # per image, its category names
    longest: int = 0  # labels of the image that has the most


@dataclass
class TrainImage:
    image: np.ndarray  # uint8 [h, w, 3] at its training size
    names: List[str]
    boxes_xyxy: np.ndarray  # [N, 4] absolute
    labels: np.ndarray  # [N] index into names


def _pixels(size: Tuple[int, int], gen: torch.Generator) -> np.ndarray:
    h, w = size
    return torch.randint(0, 256, (h, w, 3), generator=gen, dtype=torch.uint8,
                         device=gen.device).cpu().numpy()


def serve_images(mix: Dict) -> List[Tuple[Tuple[int, int], int]]:
    """((h, w), label count) of every image of a serving cycle, in the
    order that forms its requests: landscape first, then portrait."""
    images = [((int(h), int(w)), int(t["labels"])) for t in mix["tasks"]
              for h, w in t["sizes"]]
    out = []
    for portrait in (False, True):
        group = [im for im in images if (im[0][0] > im[0][1]) == portrait]
        if len(group) % mix["batch"]:
            raise ValueError(f"{len(group)} {'portrait' if portrait else 'landscape'} images "
                             f"do not form requests of {mix['batch']}")
        out += group
    return out


def serve_cycle(mix: Dict, seed: int, device: torch.device) -> List[Request]:
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    images = serve_images(mix)
    photos = {s: _pixels(s, gen) for s in sorted({s for s, _ in images})}
    names = mix["names"]
    reqs = []
    for r in range(0, len(images), mix["batch"]):
        group = images[r:r + mix["batch"]]
        labels = [[names[j] for j in rng.permutation(len(names))[:c]] for _, c in group]
        reqs.append(Request(images=[photos[s] for s, _ in group], labels=labels,
                            longest=max(c for _, c in group)))
    order = rng.permutation(len(reqs))
    return [reqs[i] for i in order]


def train_cycle(mix: Dict, seed: int, device: torch.device) -> List[List[TrainImage]]:
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    shorts = mix["train_short_sides"]
    aspects, longs = mix["photos"]["aspect"], mix["photos"]["long_side"]
    counts = list(mix["label_counts"].values())
    names = mix["names"]
    lo, hi = mix["boxes_per_label"]
    batches = []
    for b in range(mix["batches"]):
        batch = []
        for j in range(mix["batch"]):
            i = b * mix["batch"] + j
            a, bb = aspects[(i // len(shorts)) % len(aspects)]
            ls = longs[i % len(longs)]
            h, w = shortest_edge_size(int(round(ls * bb / a)), ls, shorts[i % len(shorts)],
                                      mix["max_size"])
            c = counts[i % len(counts)]
            picked = [names[k] for k in rng.permutation(len(names))[:c]]
            boxes, labels = [], []
            for lab in range(c):
                for _ in range(int(rng.integers(lo, hi + 1))):
                    cx, cy = rng.uniform(0.1, 0.9, 2)
                    bw, bh = rng.uniform(0.05, 0.5, 2)
                    x0, x1 = max(cx - bw / 2, 0.0) * w, min(cx + bw / 2, 1.0) * w
                    y0, y1 = max(cy - bh / 2, 0.0) * h, min(cy + bh / 2, 1.0) * h
                    boxes.append([x0, y0, x1, y1])
                    labels.append(lab)
            batch.append(TrainImage(image=_pixels((h, w), gen), names=picked,
                                    boxes_xyxy=np.asarray(boxes, np.float32),
                                    labels=np.asarray(labels, np.int64)))
        batches.append(batch)
    order = rng.permutation(len(batches))
    return [batches[i] for i in order]


def caption(names: Sequence[str]) -> str:
    return ".".join(n.lower().strip() for n in names) + "."


def vocab_words(mix: Dict) -> List[str]:
    return sorted({w for n in mix["names"] for w in n.lower().split()})
