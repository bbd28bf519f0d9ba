"""The reference's ZiRa train step: the set criterion (Hungarian matching on
focal + L1 + GIoU costs, scipy's exact solver; focal, L1 and GIoU losses on
the last decoder layer, the five auxiliary layers and the two-stage head),
the zero-interference losses, and the update: the global-norm clip, then
AdamW (decoupled weight decay scaled by the lr, eps 1e-8) with a per-tensor
lr factor. A frozen copy of the mathematics of DETR's `SetCriterion` /
`HungarianMatcher` and ZiRa's `train_net.py` as the measured port computes
them; it imports nothing of the measured program."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference.model import box_cxcywh_to_xyxy, per_category

WEIGHTS = {"loss_class": 1.0, "loss_bbox": 5.0, "loss_giou": 2.0}


def _giou_parts(a, b):
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    lt, rb = torch.maximum(a[..., :2], b[..., :2]), torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a + area_b - inter
    iou = inter / union.clamp(min=1e-6)
    lt2, rb2 = torch.minimum(a[..., :2], b[..., :2]), torch.maximum(a[..., 2:], b[..., 2:])
    wh2 = (rb2 - lt2).clamp(min=0.0)
    enc = wh2[..., 0] * wh2[..., 1]
    return iou - (enc - union) / enc.clamp(min=1e-6)


def giou_matrix(a, b):
    return _giou_parts(a[..., :, None, :], b[..., None, :, :])


def cost_matrix(logits, boxes, labels, tboxes, valid, alpha=0.25, gamma=2.0):
    p = torch.sigmoid(logits.float())
    neg = (1 - alpha) * p ** gamma * -torch.log(1 - p + 1e-8)
    pos = alpha * (1 - p) ** gamma * -torch.log(p + 1e-8)
    c = pos - neg
    lab = labels.long().clamp(0, c.shape[-1] - 1)
    c_class = torch.gather(c, 2, lab[:, None, :].expand(-1, c.shape[1], -1))
    c_bbox = (boxes.float()[:, :, None] - tboxes.float()[:, None]).abs().sum(-1)
    c_giou = -giou_matrix(box_cxcywh_to_xyxy(boxes.float()), box_cxcywh_to_xyxy(tboxes.float()))
    cost = 5.0 * c_bbox + 2.0 * c_class + 2.0 * c_giou
    return torch.where(valid[:, None, :], cost, torch.full_like(cost, 1.0e7))


def assign(cost: torch.Tensor) -> torch.Tensor:
    """[B, Q, N] -> [B, N] query per target (scipy's exact solver)."""
    from scipy.optimize import linear_sum_assignment

    c = cost.detach().cpu().numpy().astype(np.float64)
    out = np.zeros((c.shape[0], c.shape[2]), np.int64)
    for i in range(c.shape[0]):
        rows, cols = linear_sum_assignment(c[i])
        out[i, cols] = rows
    return torch.from_numpy(out).to(cost.device)


def _losses(logits, boxes, labels, tboxes, valid, q_of, num_boxes, alpha=0.25, gamma=2.0):
    b, q, c = logits.shape
    safe_q = torch.where(valid, q_of, 0)
    safe_l = torch.where(valid, labels.long(), 0).clamp(0, c - 1)
    bi = torch.arange(b, device=logits.device)[:, None].expand_as(safe_q)
    onehot = torch.zeros(b, q, c, device=logits.device)
    onehot.index_put_((bi, safe_q, safe_l), valid.float(), accumulate=True)
    t = onehot.clamp(0.0, 1.0)
    x = logits.float()
    p = torch.sigmoid(x)
    ce = x.clamp(min=0.0) - x * t + torch.log1p(torch.exp(-x.abs()))
    p_t = p * t + (1 - p) * (1 - t)
    focal = ((alpha * t + (1 - alpha) * (1 - t)) * ce * (1 - p_t) ** gamma).sum()
    matched = torch.gather(boxes, 1, safe_q[..., None].expand(-1, -1, 4))
    l1 = ((matched - tboxes).abs() * valid[..., None].float()).sum()
    giou = _giou_parts(box_cxcywh_to_xyxy(matched), box_cxcywh_to_xyxy(tboxes))
    return {"loss_class": focal / num_boxes, "loss_bbox": l1 / num_boxes,
            "loss_giou": ((1 - giou) * valid.float()).sum() / num_boxes}


def match_gap(cost: torch.Tensor, q_of: torch.Tensor, valid: torch.Tensor) -> Dict[str, float]:
    """How far an assignment's total cost lies above the optimum's, the
    widest over the images: `match_gap` over the sum of the optimum's
    |costs|, `match_spread` over the sum over the targets of the spread
    (standard deviation over the queries) of each target's costs."""
    best = assign(cost)
    gap = {"match_gap": 0.0, "match_spread": 0.0}
    for i in range(cost.shape[0]):
        cols = torch.nonzero(valid[i]).flatten()
        if not len(cols):
            continue
        got = cost[i, q_of[i, cols], cols].double().sum()
        opt = cost[i, best[i, cols], cols].double()
        spread = cost[i][:, cols].double().std(0).sum()
        gap["match_gap"] = max(gap["match_gap"],
                               float((got - opt.sum()) / opt.abs().sum().clamp(min=1e-30)))
        gap["match_spread"] = max(gap["match_spread"],
                                  float((got - opt.sum()) / spread.clamp(min=1e-30)))
    return gap


def total_loss(out: Dict, batch: Dict, loss_adapter_weight: float,
               assignments: Sequence[torch.Tensor] = None) -> Tuple[torch.Tensor, List, Dict]:
    """(weighted total, the assignments of the 7 outputs, the widest
    `match_gap` readings of the given ones). With `assignments` (the 7 outputs'
    [B, N] query indices, in the order last, auxiliary, two-stage) the losses
    take them, and their distance from this model's optimum is measured;
    else the exact solver assigns."""
    c2t = batch["cate_to_token_mask"]
    labels, tboxes, valid = batch["gt_labels"], batch["gt_boxes"], batch["gt_valid"]
    outs = [out] + list(out["aux_outputs"]) + [out["interm_outputs"]]
    num_boxes = valid.float().sum().clamp(min=1.0)
    total = torch.zeros((), device=labels.device)
    used, gap = [], {"match_gap": 0.0, "match_spread": 0.0}
    for j, o in enumerate(outs):
        cls = per_category(o["pred_logits"], c2t)
        with torch.no_grad():
            cost = cost_matrix(cls, o["pred_boxes"], labels, tboxes, valid)
            if assignments is None:
                q_of = assign(cost)
            else:
                q_of = assignments[j].to(cost.device).long()
                for k, v in match_gap(cost, q_of, valid).items():
                    gap[k] = max(gap[k], v)
        used.append(q_of)
        for k, v in _losses(cls, o["pred_boxes"], labels, tboxes, valid, q_of,
                            num_boxes).items():
            total = total + WEIGHTS[k] * v
    total = total + loss_adapter_weight * (out["loss_conv_adapter"] + out["loss_linear_adapter"])
    return total, used, gap


@torch.no_grad()
def clip_(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.clamp(max_norm / norm, max=1.0)
    for g in grads:
        g.mul_(scale)
    return norm


class AdamW:
    """AdamW over named tensors: lr times the product of the factors whose
    pattern is in the name."""

    def __init__(self, params: Dict[str, torch.Tensor], lr, betas, weight_decay,
                 lr_factors: Sequence[Tuple[str, float]], eps=1e-8):
        self.params = params
        self.b1, self.b2 = betas
        self.wd, self.eps = weight_decay, eps
        self.lr = {}
        for n in params:
            f = 1.0
            for pat, fac in lr_factors:
                if pat in n:
                    f *= fac
            self.lr[n] = lr * f
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        for n, p in self.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            lr = self.lr[n]
            p.mul_(1 - lr * self.wd)
            self.m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            mh = self.m[n] / (1 - self.b1 ** self.t)
            vh = self.v[n] / (1 - self.b2 ** self.t)
            p.add_(-lr * mh / (vh.sqrt() + self.eps))
            p.grad = None
