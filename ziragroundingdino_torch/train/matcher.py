"""Hungarian matching, the port of the JAX package's `train/matcher.py`
(reference `matcher/matcher.py:37-151`: focal class cost + L1 + GIoU with
weights class 2, bbox 5, giou 2).

Targets are padded [B, N] arrays with a validity mask; invalid target
columns cost `BIG`, so they take the leftover queries without changing the
optimum of the valid sub-problem. The exact assignment runs on the host with
`scipy.optimize.linear_sum_assignment`, the reference's own execution model
(`matcher.py:143-147`) and the JAX package's `impl="scipy"`.

Output convention: `assignment[b, n]` is the query matched to target n
(mask invalid entries with the target validity downstream).
"""

from __future__ import annotations

import numpy as np
import torch

from ziragroundingdino_torch.ops.box_ops import box_cxcywh_to_xyxy, generalized_box_iou_matrix

BIG = 1.0e7


def focal_class_cost(pred_logits: torch.Tensor, tgt_labels: torch.Tensor, alpha: float = 0.25,
                     gamma: float = 2.0) -> torch.Tensor:
    """[B, Q, C] logits, [B, N] labels -> [B, Q, N] focal cost
    (`matcher.py:125-131`, with its -log(1 - p + 1e-8)). Labels are clamped
    to [0, C) as JAX's indexing clamps them."""
    prob = torch.sigmoid(pred_logits.float())
    neg = (1.0 - alpha) * prob ** gamma * -torch.log(1.0 - prob + 1e-8)
    pos = alpha * (1.0 - prob) ** gamma * -torch.log(prob + 1e-8)
    cost = pos - neg  # [B, Q, C]
    labels = tgt_labels.long().clamp(0, cost.shape[-1] - 1)
    return torch.gather(cost, 2, labels[:, None, :].expand(-1, cost.shape[1], -1))


def pairwise_cost_matrix(
    pred_logits: torch.Tensor,  # [B, Q, C]
    pred_boxes: torch.Tensor,  # [B, Q, 4] cxcywh
    tgt_labels: torch.Tensor,  # [B, N]
    tgt_boxes: torch.Tensor,  # [B, N, 4] cxcywh
    tgt_valid: torch.Tensor,  # [B, N] bool
    cost_class: float = 2.0,
    cost_bbox: float = 5.0,
    cost_giou: float = 2.0,
    alpha: float = 0.25,
    gamma: float = 2.0,
) -> torch.Tensor:
    """[B, Q, N] combined cost; invalid target columns are `BIG`."""
    c_class = focal_class_cost(pred_logits, tgt_labels, alpha, gamma)
    pb, tb = pred_boxes.float(), tgt_boxes.float()
    c_bbox = (pb[:, :, None] - tb[:, None]).abs().sum(-1)  # cdist, p=1
    c_giou = -generalized_box_iou_matrix(box_cxcywh_to_xyxy(pb), box_cxcywh_to_xyxy(tb))
    cost = cost_bbox * c_bbox + cost_class * c_class + cost_giou * c_giou
    return torch.where(tgt_valid[:, None, :], cost, torch.full_like(cost, BIG))


def assign(cost: torch.Tensor) -> torch.Tensor:
    """Exact minimum-cost assignment of [B, Q, N] costs (N <= Q), on the host:
    returns [B, N] int64 query indices on the cost's device."""
    from scipy.optimize import linear_sum_assignment

    c = cost.detach().float().cpu().numpy()
    out = np.zeros((c.shape[0], c.shape[2]), np.int64)
    for i in range(c.shape[0]):
        rows, cols = linear_sum_assignment(c[i])
        out[i, cols] = rows
    return torch.from_numpy(out).to(cost.device)


@torch.no_grad()
def match_batch(pred_logits, pred_boxes, tgt_labels, tgt_boxes, tgt_valid) -> torch.Tensor:
    """[B, N] query index per target; not differentiable (`matcher.py:81`)."""
    return assign(pairwise_cost_matrix(pred_logits, pred_boxes, tgt_labels, tgt_boxes,
                                       tgt_valid))
