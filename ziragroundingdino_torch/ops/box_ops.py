"""Box utilities, the port of the JAX package's `ops/box_ops.py` (reference
`util/box_ops.py:9-144`): cxcywh <-> xyxy, pairwise and elementwise IoU and
generalized IoU, boxes around masks, and the clamped logit
`inverse_sigmoid`. Shape-polymorphic over leading dims; degenerate boxes are
not asserted against (callers mask).
"""

from __future__ import annotations

from typing import Tuple

import torch


def box_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack([(x0 + x1) * 0.5, (y0 + y1) * 0.5, x1 - x0, y1 - y0], dim=-1)


def box_area(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def _iou(lt_in, rb_in, area1, area2) -> Tuple[torch.Tensor, torch.Tensor]:
    """IoU and union from the intersection's corners."""
    wh = (rb_in - lt_in).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter
    return inter / union.clamp(min=1e-6), union


def _giou(lt_in, rb_in, lt_out, rb_out, area1, area2) -> Tuple[torch.Tensor, torch.Tensor]:
    """GIoU and IoU from the intersection's and the enclosing box's corners."""
    iou, union = _iou(lt_in, rb_in, area1, area2)
    wh = (rb_out - lt_out).clamp(min=0.0)
    enclosing = wh[..., 0] * wh[..., 1]
    return iou - (enclosing - union) / enclosing.clamp(min=1e-6), iou


def box_iou_pairwise_matrix(boxes1: torch.Tensor,
                            boxes2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-pairs IoU of xyxy boxes: [N, 4] x [M, 4] -> ([N, M] iou, [N, M] union)."""
    a, b = boxes1[..., :, None, :], boxes2[..., None, :, :]
    return _iou(torch.maximum(a[..., :2], b[..., :2]), torch.minimum(a[..., 2:], b[..., 2:]),
                box_area(boxes1)[..., :, None], box_area(boxes2)[..., None, :])


def box_iou_elementwise(boxes1: torch.Tensor,
                        boxes2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """IoU and union of aligned xyxy boxes [..., 4] -> ([...], [...])."""
    return _iou(torch.maximum(boxes1[..., :2], boxes2[..., :2]),
                torch.minimum(boxes1[..., 2:], boxes2[..., 2:]),
                box_area(boxes1), box_area(boxes2))


def generalized_box_iou_matrix(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """All-pairs GIoU of xyxy boxes: [N, 4] x [M, 4] -> [N, M]."""
    a, b = boxes1[..., :, None, :], boxes2[..., None, :, :]
    return _giou(torch.maximum(a[..., :2], b[..., :2]), torch.minimum(a[..., 2:], b[..., 2:]),
                 torch.minimum(a[..., :2], b[..., :2]), torch.maximum(a[..., 2:], b[..., 2:]),
                 box_area(boxes1)[..., :, None], box_area(boxes2)[..., None, :])[0]


def generalized_box_iou_elementwise(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """GIoU of aligned xyxy boxes [..., 4] -> [...]."""
    return _giou(torch.maximum(boxes1[..., :2], boxes2[..., :2]),
                 torch.minimum(boxes1[..., 2:], boxes2[..., 2:]),
                 torch.minimum(boxes1[..., :2], boxes2[..., :2]),
                 torch.maximum(boxes1[..., 2:], boxes2[..., 2:]),
                 box_area(boxes1), box_area(boxes2))[0]


def masks_to_boxes(masks: torch.Tensor) -> torch.Tensor:
    """xyxy boxes around binary masks [N, H, W] -> [N, 4] f32. An empty mask
    gives (1e8, 1e8, 0, 0), as the JAX package's."""
    n, h, w = masks.shape
    m = masks.bool()
    big = torch.tensor(1e8, dtype=torch.float32, device=masks.device)
    ys = torch.arange(h, dtype=torch.float32, device=masks.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=masks.device)[None, None, :]
    x_mask, y_mask = masks.float() * xs, masks.float() * ys
    return torch.stack([torch.where(m, x_mask, big).amin(dim=(1, 2)),
                        torch.where(m, y_mask, big).amin(dim=(1, 2)),
                        x_mask.amax(dim=(1, 2)), y_mask.amax(dim=(1, 2))], dim=1)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Logit with the reference's clamping (`util/misc.py:704-709`)."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))
