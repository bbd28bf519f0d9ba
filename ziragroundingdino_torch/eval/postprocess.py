"""Detection post-processing on tensors, the port of the JAX package's
`eval/postprocess.py` (reference `dt_inference`, `groundingdino_dt.py:
701-742`): sigmoid of the per-category logits, the global top-k over
(query x category), the boxes gathered, converted cxcywh -> xyxy and scaled
to the original image size, clipped (boxes are normalized by the resized
image, so scaling straight to the original size is the reference's
`Boxes.scale` + `detector_postprocess`)."""

from __future__ import annotations

from typing import Dict

import torch

from ziragroundingdino_torch.ops.box_ops import box_cxcywh_to_xyxy


def top_k_detections(class_logits: torch.Tensor,  # [B, Q, C] per-category logits
                     pred_boxes: torch.Tensor,  # [B, Q, 4] cxcywh normalized
                     k: int = 200) -> Dict[str, torch.Tensor]:
    """The k best (query, category) pairs per image: `scores` [B, K],
    `labels` [B, K], `boxes_cxcywh` [B, K, 4]. Ties go to the lower flat
    index, as `jax.lax.top_k` breaks them (the categories a caption lacks
    all score sigmoid(-100)); k is clamped to Q * C."""
    b, q, c = class_logits.shape
    prob = torch.sigmoid(class_logits.float()).reshape(b, q * c)
    k = min(k, q * c)
    scores, idx = torch.sort(prob, dim=1, descending=True, stable=True)
    scores, idx = scores[:, :k], idx[:, :k]
    query = idx // c
    boxes = torch.gather(pred_boxes, 1, query[..., None].expand(-1, -1, 4))
    return {"scores": scores, "labels": idx % c, "boxes_cxcywh": boxes}


def scale_to_original(boxes_cxcywh: torch.Tensor,  # [B, K, 4] normalized
                      orig_sizes: torch.Tensor  # [B, 2] (h, w)
                      ) -> torch.Tensor:
    """xyxy in the original image's pixels, clipped to it."""
    xyxy = box_cxcywh_to_xyxy(boxes_cxcywh.float())
    h = orig_sizes[:, 0:1].float()
    w = orig_sizes[:, 1:2].float()
    scale = torch.cat([w, h, w, h], dim=-1)[:, None, :]
    return torch.minimum((xyxy * scale).clamp(min=0.0), scale)
