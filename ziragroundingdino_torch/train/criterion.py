"""DETR set criterion (focal class + L1 + GIoU) over padded targets, the port
of the JAX package's `train/criterion.py` (reference `criterion/criterion.py:
107-193`, `two_stage_criterion.py:19-100`, weights `criterion/__init__.py:
22-40`, `sigmoid_focal_loss` `models/GroundingDINO/utils.py:137-169`).

Targets are [B, N] arrays with a validity mask; the assignment is
`matcher.match_batch`'s [B, N] target -> query indices. The outputs (last
layer, aux layers, encoder head) all hold the same number of queries, so
they are matched together: one `match_batch` call on the outputs stacked
along the batch, one kernel launch on the card. `num_boxes` is the count of
valid targets in the global batch, at least 1: a data-parallel rank divides
its sums by that count over the number of ranks (`parallel.dist.
global_divisor`), so that DDP's mean of the ranks' gradients is the
gradient of the global batch's loss (`criterion.py:9-11` of the JAX
package: under pjit its batch is the global one).
"""

from __future__ import annotations

from typing import Dict

import torch

from ziragroundingdino_torch.ops.box_ops import box_cxcywh_to_xyxy, generalized_box_iou_elementwise
from ziragroundingdino_torch.parallel.dist import global_divisor
from ziragroundingdino_torch.train.matcher import match_batch

WEIGHT_DICT = {"loss_class": 1.0, "loss_bbox": 5.0, "loss_giou": 2.0}


def sigmoid_focal_loss_sum(logits: torch.Tensor, targets: torch.Tensor, alpha: float = 0.25,
                           gamma: float = 2.0) -> torch.Tensor:
    """Sum over all entries (the reference's mean(1).sum() / num_boxes * Q is
    sum() / num_boxes); BCE with logits in its stable form."""
    x, t = logits.float(), targets.float()
    p = torch.sigmoid(x)
    ce = x.clamp(min=0.0) - x * t + torch.log1p(torch.exp(-x.abs()))
    p_t = p * t + (1.0 - p) * (1.0 - t)
    loss = ce * (1.0 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * t + (1.0 - alpha) * (1.0 - t)) * loss
    return loss.sum()


def _losses_for_output(pred_logits, pred_boxes, tgt_labels, tgt_boxes, tgt_valid, assignment,
                       num_boxes, alpha: float, gamma: float) -> Dict[str, torch.Tensor]:
    b, q, c = pred_logits.shape
    valid = tgt_valid.float()
    # class targets: one-hot at (assigned query, label) of each valid target
    safe_q = torch.where(tgt_valid, assignment, 0).long()
    safe_l = torch.where(tgt_valid, tgt_labels.long(), 0).clamp(0, c - 1)
    batch_idx = torch.arange(b, device=pred_logits.device)[:, None].expand_as(safe_q)
    onehot = torch.zeros(b, q, c, device=pred_logits.device)
    onehot.index_put_((batch_idx, safe_q, safe_l), valid, accumulate=True)
    loss_class = sigmoid_focal_loss_sum(pred_logits, onehot.clamp(0.0, 1.0), alpha, gamma)

    matched = torch.gather(pred_boxes, 1, safe_q[..., None].expand(-1, -1, 4))  # [B, N, 4]
    l1 = ((matched - tgt_boxes).abs() * valid[..., None]).sum()
    giou = generalized_box_iou_elementwise(box_cxcywh_to_xyxy(matched),
                                           box_cxcywh_to_xyxy(tgt_boxes))
    loss_giou = ((1.0 - giou) * valid).sum()
    return {"loss_class": loss_class / num_boxes, "loss_bbox": l1 / num_boxes,
            "loss_giou": loss_giou / num_boxes}


def set_criterion(outputs: Dict, tgt_labels: torch.Tensor, tgt_boxes: torch.Tensor,
                  tgt_valid: torch.Tensor, matcher_impl: str = "lsap", alpha: float = 0.25,
                  gamma: float = 2.0) -> Dict[str, torch.Tensor]:
    """Last layer, aux `_{i}` and two-stage `_enc` losses, unweighted. Each
    output is matched on its own costs; all are solved in one
    `match_batch(..., impl=matcher_impl)` call."""
    num_boxes = global_divisor(tgt_valid.float().sum())
    suffixed = [("", outputs)]
    suffixed += [(f"_{i}", aux) for i, aux in enumerate(outputs.get("aux_outputs", ()))]
    if "interm_outputs" in outputs:
        suffixed.append(("_enc", outputs["interm_outputs"]))
    k = len(suffixed)
    with torch.no_grad():
        logits = torch.cat([o["pred_logits"].float() for _, o in suffixed])
        boxes = torch.cat([o["pred_boxes"].float() for _, o in suffixed])
    assignments = match_batch(logits, boxes, tgt_labels.repeat(k, 1), tgt_boxes.repeat(k, 1, 1),
                              tgt_valid.repeat(k, 1), impl=matcher_impl).chunk(k)
    losses = {}
    for (suffix, out), assignment in zip(suffixed, assignments):
        one = _losses_for_output(out["pred_logits"], out["pred_boxes"], tgt_labels, tgt_boxes,
                                 tgt_valid, assignment, num_boxes, alpha, gamma)
        losses.update({name + suffix: v for name, v in one.items()})
    return losses


def weighted_total(losses: Dict[str, torch.Tensor]) -> torch.Tensor:
    """{class 1, bbox 5, giou 2} applied to every suffixed duplicate, summed."""
    total = 0.0
    for k, v in losses.items():
        for base, w in WEIGHT_DICT.items():
            if k == base or k.startswith(base + "_"):
                total = total + w * v
                break
    return total
