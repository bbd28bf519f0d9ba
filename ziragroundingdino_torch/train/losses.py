"""Standalone loss library (mmdet-style), the port of the JAX package's
`train/losses.py` (reference `models/GroundingDINO/losses/*.py`: FocalLoss,
GIoULoss, L1Loss, CrossEntropyLoss, DiceLoss). Functional, with mmdet's
`weight` / `reduction` / `avg_factor` semantics: a weight multiplies the
elementwise loss, "mean" with an `avg_factor` divides the sum by it.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from ziragroundingdino_torch.ops.box_ops import box_cxcywh_to_xyxy, generalized_box_iou_elementwise

Factor = Union[float, torch.Tensor, None]


def reduce_loss(loss: torch.Tensor, weight: Optional[torch.Tensor], reduction: str,
                avg_factor: Factor) -> torch.Tensor:
    if weight is not None:
        loss = loss * weight
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if reduction == "mean":
        if avg_factor is None:
            return loss.mean()
        return loss.sum() / torch.clamp(torch.as_tensor(avg_factor, dtype=loss.dtype,
                                                        device=loss.device), min=1e-12)
    raise ValueError(reduction)


def sigmoid_focal_loss(pred: torch.Tensor, target: torch.Tensor, weight=None,
                       alpha: float = 0.25, gamma: float = 2.0, reduction: str = "mean",
                       avg_factor: Factor = None) -> torch.Tensor:
    """Elementwise binary focal loss on logits (targets are one-hot floats).
    The cross-entropy is taken from the logits (max(x, 0) - x t +
    log1p(exp(-|x|))), never from a log of the sigmoid, so saturated logits
    give finite losses."""
    x = pred.float()
    t = target.float()
    p = torch.sigmoid(x)
    ce = x.clamp(min=0.0) - x * t + torch.log1p(torch.exp(-x.abs()))
    p_t = p * t + (1 - p) * (1 - t)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * t + (1 - alpha) * (1 - t)) * loss
    return reduce_loss(loss, weight, reduction, avg_factor)


def l1_loss(pred, target, weight=None, reduction="mean", avg_factor=None):
    return reduce_loss((pred - target).abs(), weight, reduction, avg_factor)


def smooth_l1_loss(pred, target, beta: float = 1.0, weight=None, reduction="mean",
                   avg_factor=None):
    d = (pred - target).abs()
    loss = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    return reduce_loss(loss, weight, reduction, avg_factor)


def giou_loss(pred_cxcywh, target_cxcywh, weight=None, reduction="mean", avg_factor=None):
    giou = generalized_box_iou_elementwise(box_cxcywh_to_xyxy(pred_cxcywh),
                                           box_cxcywh_to_xyxy(target_cxcywh))
    return reduce_loss(1.0 - giou, weight, reduction, avg_factor)


def cross_entropy_loss(pred_logits, target_idx, weight=None, reduction="mean",
                       avg_factor=None):
    logp = F.log_softmax(pred_logits.float(), dim=-1)
    loss = -torch.gather(logp, -1, target_idx.long()[..., None])[..., 0]
    return reduce_loss(loss, weight, reduction, avg_factor)


def dice_loss(pred, target, weight=None, eps: float = 1e-3, reduction="mean",
              avg_factor=None):
    """pred: logits over flattened masks [N, M]; target in {0, 1}."""
    p = torch.sigmoid(pred.float())
    t = target.float()
    num = 2.0 * (p * t).sum(-1) + eps
    den = p.sum(-1) + t.sum(-1) + eps
    return reduce_loss(1.0 - num / den, weight, reduction, avg_factor)
