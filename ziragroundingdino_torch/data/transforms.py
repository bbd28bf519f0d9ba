"""Host-side image decoding and transforms (numpy + torch on the CPU), the
port of the JAX package's `data/transforms.py` and `load_image`.

Train augmentation (detectron2 style, `config/configs/common/data/odinw/
aquarium.py:49-60`, `datasets/detr_dataset_mapper.py:40-70`): random flip,
then with probability 1/2 a resize to a short side of 400/500/600 and a
random crop of 384-600 pixels, then a multi-scale shortest-edge resize.
Eval: shortest side 800, longest at most 1333. Every random draw comes from
the `np.random.RandomState` passed in, in the JAX package's order, so both
packages draw the same augmentation. After the resize every image is padded
to the smallest static (H, W) bucket that fits, with a validity mask (True
= real pixel).

The resize is torch's antialiased bilinear `interpolate` on float32,
rounded and clamped: within one uint8 level of PIL's `BILINEAR`, which the
JAX package uses. Decoding reads binary PPM (`P6`) with numpy; other formats
need PIL, imported only when such a file is read.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ziragroundingdino_torch.config import DataConfig


@dataclasses.dataclass
class Sample:
    """One decoded example (host)."""

    image: np.ndarray  # [H, W, 3] uint8
    boxes: np.ndarray  # [N, 4] absolute xyxy
    labels: np.ndarray  # [N] int
    # size before any resize (h, w): eval boxes are scaled back to it
    orig_size: Tuple[int, int] = (0, 0)
    image_id: int = 0
    # iscrowd regions: ignored by the evaluator's matching, never trained on
    crowd_boxes: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 4), np.float32))
    crowd_labels: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), np.int64))
    # the annotations' "area" (original-image pixels), which COCO's s/m/l
    # ranges use; empty means the box area
    gt_areas: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), np.float32))


def _read_ppm(path: str) -> np.ndarray:
    """Binary PPM (P6, maxval 255) -> [H, W, 3] uint8."""
    with open(path, "rb") as f:
        data = f.read()
    fields, pos = [], 0
    while len(fields) < 4:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos)
            continue
        end = pos
        while end < len(data) and not data[end:end + 1].isspace() and data[end:end + 1] != b"#":
            end += 1
        fields.append(data[pos:end])
        pos = end
    magic, w, h, maxval = fields[0], int(fields[1]), int(fields[2]), int(fields[3])
    if magic != b"P6" or maxval != 255:
        raise ValueError(f"{path}: only binary 8-bit PPM (P6, maxval 255) is read without PIL")
    pos += 1  # the one whitespace byte after maxval
    pixels = np.frombuffer(data, np.uint8, count=h * w * 3, offset=pos)
    return pixels.reshape(h, w, 3).copy()


def read_image(path: str) -> np.ndarray:
    """Decode an image file to [H, W, 3] uint8 RGB: PPM with numpy, other
    formats with PIL where it is installed."""
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"P6":
        return _read_ppm(path)
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"{path}: decoding this format needs PIL, which is not installed; "
            "the port reads binary PPM (P6) without it") from None
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def resize_u8(image: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """Bilinear resize of [H, W, 3] uint8 with antialiasing (within one
    level of PIL's `BILINEAR`)."""
    x = torch.from_numpy(np.ascontiguousarray(image, np.uint8)).permute(2, 0, 1)[None].float()
    y = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False, antialias=True)
    return y[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()


def shortest_edge_size(h: int, w: int, short: int, max_size: int) -> Tuple[int, int]:
    """detectron2's ResizeShortestEdge: the (h, w) that scales the short side
    to `short`, unless the long side would then exceed `max_size`."""
    scale = short / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    return int(round(h * scale)), int(round(w * scale))


def resize_shortest_edge(image: np.ndarray, boxes: np.ndarray, short: int,
                         max_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Resize to `shortest_edge_size`, the boxes with the image."""
    h, w = image.shape[:2]
    nh, nw = shortest_edge_size(h, w, short, max_size)
    if (nh, nw) != (h, w):
        image = resize_u8(image, nh, nw)
    if boxes.size:
        boxes = boxes * np.array([nw / w, nh / h, nw / w, nh / h], np.float32)
    return image, boxes


def random_flip(image, boxes, rng: np.random.RandomState):
    if rng.rand() < 0.5:
        image = image[:, ::-1]
        if boxes.size:
            w = image.shape[1]
            boxes = boxes.copy()
            boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
    return image, boxes


def random_crop_absolute_range(image, boxes, labels, rng: np.random.RandomState,
                               crop_range=(384, 600)):
    """detectron2's RandomCrop("absolute_range", (384, 600)), the crop of the
    50% branch; boxes are clipped to the crop and empty ones dropped."""
    h, w = image.shape[:2]
    ch = min(h, rng.randint(crop_range[0], crop_range[1] + 1))
    cw = min(w, rng.randint(crop_range[0], crop_range[1] + 1))
    y0 = rng.randint(0, h - ch + 1)
    x0 = rng.randint(0, w - cw + 1)
    image = image[y0: y0 + ch, x0: x0 + cw]
    if boxes.size:
        boxes = boxes - np.array([x0, y0, x0, y0], np.float32)
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, cw)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, ch)
        keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
        boxes, labels = boxes[keep], labels[keep]
    return image, boxes, labels


def pick_bucket(h: int, w: int, buckets: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    """Smallest bucket that fits (h, w); falls back to the largest."""
    fitting = [b for b in buckets if b[0] >= h and b[1] >= w]
    if not fitting:
        return max(buckets, key=lambda b: b[0] * b[1])
    return min(fitting, key=lambda b: b[0] * b[1])


def pad_to_bucket(image: np.ndarray, bucket: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """Bottom/right zero pad + validity mask (True = real pixel). The image
    must already fit the bucket."""
    h, w = image.shape[:2]
    bh, bw = bucket
    if h > bh or w > bw:
        raise ValueError(f"image {h}x{w} does not fit bucket {bh}x{bw}")
    out = np.zeros((bh, bw) + image.shape[2:], image.dtype)
    out[:h, :w] = image
    mask = np.zeros((bh, bw), bool)
    mask[:h, :w] = True
    return out, mask


def normalize(image: np.ndarray, cfg: DataConfig) -> np.ndarray:
    """(x - mean) / std, channels last."""
    mean = np.asarray(cfg.pixel_mean, np.float32)
    std = np.asarray(cfg.pixel_std, np.float32)
    return (image.astype(np.float32) - mean) / std


def train_transform(sample: Sample, cfg: DataConfig, rng: np.random.RandomState) -> Sample:
    image, boxes, labels = sample.image, sample.boxes, sample.labels
    if cfg.random_flip:
        image, boxes = random_flip(image, boxes, rng)
    if rng.rand() < 0.5:
        # the crop branch: resize to a short side of 400-600, then crop
        short = rng.choice([400, 500, 600])
        image, boxes = resize_shortest_edge(image, boxes, int(short), cfg.max_size * 4)
        image, boxes, labels = random_crop_absolute_range(image, boxes, labels, rng)
    short = int(rng.choice(cfg.train_short_sides))
    image, boxes = resize_shortest_edge(image, boxes, short, cfg.max_size)
    return dataclasses.replace(sample, image=image, boxes=boxes, labels=labels)


def eval_size(h: int, w: int, cfg: DataConfig) -> Tuple[int, int]:
    """The size `eval_transform` gives an (h, w) image."""
    return shortest_edge_size(h, w, cfg.test_short_side, cfg.max_size)


def eval_transform(sample: Sample, cfg: DataConfig) -> Sample:
    image, boxes = resize_shortest_edge(sample.image, sample.boxes, cfg.test_short_side,
                                        cfg.max_size)
    crowd = sample.crowd_boxes
    if crowd.size:
        # crowd ignore-regions scale with the ground truth
        h, w = sample.image.shape[:2]
        nh, nw = image.shape[:2]
        crowd = crowd * np.array([nw / w, nh / h, nw / w, nh / h], np.float32)
    return dataclasses.replace(sample, image=image, boxes=boxes, crowd_boxes=crowd)


def load_image(path: str, cfg: Optional[DataConfig] = None):
    """`util/inference.py:35-41`: read, resize (shortest side 800, longest
    at most 1333), normalize and pad to a bucket (`cfg`: a default
    `DataConfig` when None). Returns (the decoded image uint8 [H, W, 3],
    (pixels [1, bh, bw, 3] f32, mask [1, bh, bw] bool), the resized (h, w))."""
    cfg = cfg or DataConfig()
    src = read_image(path)
    sample = Sample(image=src, boxes=np.zeros((0, 4), np.float32),
                    labels=np.zeros((0,), np.int64), orig_size=src.shape[:2])
    s = eval_transform(sample, cfg)
    bucket = pick_bucket(s.image.shape[0], s.image.shape[1], cfg.shape_buckets)
    pixels, mask = pad_to_bucket(normalize(s.image, cfg), bucket)
    return src, (pixels[None], mask[None]), s.image.shape[:2]
