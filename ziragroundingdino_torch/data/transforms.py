"""Host-side image transforms (numpy): the port's copy of `normalize`,
`pick_bucket` and `pad_to_bucket` from the JAX package's
`data/transforms.py`. Every image is padded to the smallest static (H, W) bucket
that fits, with a validity mask (True = real pixel).

The eval resize (shortest side 800, longest 1333) needs PIL or the JAX
package's native library and is not part of the port yet.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ziragroundingdino_torch.config import DataConfig


def pick_bucket(h: int, w: int, buckets: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    """Smallest bucket that fits (h, w); falls back to the largest."""
    fitting = [b for b in buckets if b[0] >= h and b[1] >= w]
    if not fitting:
        return max(buckets, key=lambda b: b[0] * b[1])
    return min(fitting, key=lambda b: b[0] * b[1])


def pad_to_bucket(image: np.ndarray, bucket: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """Bottom/right zero pad + validity mask (True = real pixel). The image
    must already fit the bucket: shrinking it needs the resize."""
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
