"""The ZiRa train step, the port of the JAX package's `train/step.py`
(reference `Trainer.run_step`, `train_net.py:92-142`).

`train_step(model, optimizer, batch, generator)`: the forward in train mode,
the set criterion on per-category logits, the ZiRa zero-interference losses,
the backward over the trainable parameters (`train.optim.set_trainable`
froze the rest, so the frozen Swin and BERT run no backward at all), then
`optim.Optimizer.step` (clip, AdamW, schedule, EMA). `generator=None` is
deterministic (no dropout), as `rngs=None` is in the JAX package.

A batch is a dict of tensors on the model's device: `pixels` [B, H, W, 3],
`mask` [B, H, W], the text batch (`input_ids`, `text_token_mask`,
`position_ids`, `text_self_attention_masks`), `cate_to_token_mask`
[B, C, T], and padded targets `gt_labels` [B, N], `gt_boxes` [B, N, 4]
cxcywh in [0, 1] and `gt_valid` [B, N].
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ziragroundingdino_torch.models.groundingdino import GroundingDINO
from ziragroundingdino_torch.text.masks import recover_to_cls_logits
from ziragroundingdino_torch.train.criterion import set_criterion, weighted_total
from ziragroundingdino_torch.train.optim import Optimizer

TEXT_KEYS = ("input_ids", "text_token_mask", "position_ids", "text_self_attention_masks")


def class_logits_from_tokens(token_logits: torch.Tensor, cate_to_token_mask: torch.Tensor,
                             fill: float = -100.0) -> torch.Tensor:
    """Token-level [B, Q, max_text_len] -> per-category [B, Q, C] logits
    (`recover_to_cls_logits`; the ZiRa training path feeds these to the
    criterion, `groundingdino_dual_zero_rep_branch.py:547-552`)."""
    t = cate_to_token_mask.shape[-1]
    return recover_to_cls_logits(token_logits[..., :t], cate_to_token_mask, fill=fill)


def compute_losses(model: GroundingDINO, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, {name: loss}) of one batch, the model in train mode."""
    cfg = model.cfg
    out = model(batch["pixels"], batch["mask"], {k: batch[k] for k in TEXT_KEYS}, train=True,
                generator=generator)
    c2t = batch["cate_to_token_mask"]

    def to_cls(o):
        return dict(o, pred_logits=class_logits_from_tokens(o["pred_logits"], c2t))

    outputs = to_cls(out)
    if "aux_outputs" in out:
        outputs["aux_outputs"] = [to_cls(a) for a in out["aux_outputs"]]
        outputs["interm_outputs"] = to_cls(out["interm_outputs"])
    losses = set_criterion(outputs, batch["gt_labels"], batch["gt_boxes"], batch["gt_valid"])
    total = weighted_total(losses)

    # ZiRa zero-interference losses (`groundingdino_dual_zero_rep_branch.py:
    # 584-587`), weighted by loss_adapter_weight, where the preset has the
    # branch and the loss (`train/step.py:76-88` of the JAX package)
    al = out["adapter_losses"]
    if cfg.use_project_adapter and cfg.use_zero_inter_loss_for_conv:
        losses["loss_conv_adapter"] = al["loss_conv_adapter"] * cfg.loss_adapter_weight
        total = total + losses["loss_conv_adapter"]
    if cfg.use_cet and cfg.use_zero_inter_loss:
        losses["loss_linear_adapter"] = al["loss_linear_adapter"] * cfg.loss_adapter_weight
        total = total + losses["loss_linear_adapter"]
    losses["total_loss"] = total
    return total, losses


def train_step(model: GroundingDINO, optimizer: Optimizer, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """One step; returns the losses and `grad_norm` (the trainable
    gradients' global norm before the clip) as detached tensors on the
    model's device."""
    total, losses = compute_losses(model, batch, generator)
    total.backward()
    metrics = {k: v.detach() for k, v in losses.items()}
    metrics["grad_norm"] = optimizer.step()
    return metrics
