"""The reference's image path: detectron2's ResizeShortestEdge with an
antialiased bilinear resize, bottom/right zero padding to a static bucket,
and the (x - mean) / std normalisation. A frozen copy of the mathematics;
it imports nothing of the measured program."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def shortest_edge_size(h: int, w: int, short: int, max_size: int) -> Tuple[int, int]:
    scale = short / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    return int(round(h * scale)), int(round(w * scale))


def resize_u8(image: np.ndarray, nh: int, nw: int) -> np.ndarray:
    x = torch.from_numpy(np.ascontiguousarray(image)).permute(2, 0, 1)[None].float()
    y = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False, antialias=True)
    return y[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()


def pick_bucket(h: int, w: int, buckets: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    fit = [b for b in buckets if b[0] >= h and b[1] >= w]
    if not fit:
        return max(buckets, key=lambda b: b[0] * b[1])
    return min(fit, key=lambda b: b[0] * b[1])


def eval_resize(image: np.ndarray, short: int = 800, max_size: int = 1333) -> np.ndarray:
    nh, nw = shortest_edge_size(image.shape[0], image.shape[1], short, max_size)
    if (nh, nw) == image.shape[:2]:
        return image
    return resize_u8(image, nh, nw)


def pad_batch(images: Sequence[np.ndarray], bucket: Tuple[int, int]):
    """uint8 [B, bh, bw, 3] and its validity mask."""
    bh, bw = bucket
    px = np.zeros((len(images), bh, bw, 3), np.uint8)
    mask = np.zeros((len(images), bh, bw), bool)
    for i, im in enumerate(images):
        h, w = im.shape[:2]
        px[i, :h, :w] = im
        mask[i, :h, :w] = True
    return px, mask


def normalize(px: torch.Tensor, mask: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> f32, padding at 0 (as the loader's padded
    zeros after normalising)."""
    m = torch.tensor(mean, device=px.device)
    s = torch.tensor(std, device=px.device)
    return ((px.float() - m) / s).masked_fill(~mask[..., None], 0.0)
