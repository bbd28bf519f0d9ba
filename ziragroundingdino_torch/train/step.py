"""The ZiRa train step, the port of the JAX package's `train/step.py`
(reference `Trainer.run_step`, `train_net.py:92-142`).

`train_step(model, optimizer, batch, generator)`: the forward in train mode,
the set criterion on per-category logits, the ZiRa zero-interference losses,
the backward over the trainable parameters (`train.optim.set_trainable`
froze the rest, so a frozen Swin or BERT runs no backward at all; a model
with nothing trainable, `prompttune`, none), then `optim.Optimizer.step`
(clip, AdamW, schedule, EMA). `generator=None` is deterministic (no
dropout, no noisy MoE gating), as `rngs=None` is in the JAX package.

A batch is a dict of tensors on the model's device: `pixels` [B, H, W, 3],
`mask` [B, H, W], the text batch (`input_ids`, `text_token_mask`,
`position_ids`, `text_self_attention_masks`), `cate_to_token_mask`
[B, C, T], and padded targets `gt_labels` [B, N], `gt_boxes` [B, N, 4]
cxcywh in [0, 1] and `gt_valid` [B, N].
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from ziragroundingdino_torch.models.groundingdino import GroundingDINO
from ziragroundingdino_torch.parallel import dist
from ziragroundingdino_torch.text.masks import recover_to_cls_logits
from ziragroundingdino_torch.train.criterion import set_criterion, weighted_total
from ziragroundingdino_torch.train.optim import Optimizer
from ziragroundingdino_torch.utils import profiling

TEXT_KEYS = ("input_ids", "text_token_mask", "position_ids", "text_self_attention_masks")


def class_logits_from_tokens(token_logits: torch.Tensor, cate_to_token_mask: torch.Tensor,
                             fill: float = -100.0) -> torch.Tensor:
    """Token-level [B, Q, max_text_len] -> per-category [B, Q, C] logits
    (`recover_to_cls_logits`; the ZiRa training path feeds these to the
    criterion, `groundingdino_dual_zero_rep_branch.py:547-552`)."""
    t = cate_to_token_mask.shape[-1]
    return recover_to_cls_logits(token_logits[..., :t], cate_to_token_mask, fill=fill)


def compute_losses(model: GroundingDINO, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None, matcher_impl: str = "lsap"
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, {name: loss}) of one batch, the model in train mode;
    `matcher_impl` as `train.matcher.match_batch`'s `impl`."""
    cfg = model.cfg
    with profiling.span("step.forward"):
        out = model(batch["pixels"], batch["mask"], {k: batch[k] for k in TEXT_KEYS},
                    train=True, generator=generator)
    with profiling.span("step.criterion"):
        return _criterion(cfg, out, batch, matcher_impl)


def _criterion(cfg, out, batch, matcher_impl):
    """`compute_losses` after the forward: the set criterion on per-category
    logits and the ZiRa losses."""
    c2t = batch["cate_to_token_mask"]

    def to_cls(o):
        return dict(o, pred_logits=class_logits_from_tokens(o["pred_logits"], c2t))

    outputs = to_cls(out)
    if "aux_outputs" in out:
        outputs["aux_outputs"] = [to_cls(a) for a in out["aux_outputs"]]
        outputs["interm_outputs"] = to_cls(out["interm_outputs"])
    losses = set_criterion(outputs, batch["gt_labels"], batch["gt_boxes"], batch["gt_valid"],
                           matcher_impl=matcher_impl)
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
    if cfg.use_adapter:  # CAT's in-layer adapters and prompt (`step.py:86-88` there)
        losses["loss_adapter"] = al["loss_adapter"] * cfg.loss_adapter_weight
        total = total + losses["loss_adapter"]
    losses["total_loss"] = total
    return total, losses


class StepLosses(nn.Module):
    """`compute_losses` as a module: what DDP wraps, so that the whole
    forward of a step (the model and the criterion) runs inside the
    wrapper's `__call__` and its outputs are the losses alone."""

    def __init__(self, model: GroundingDINO, matcher_impl: str = "lsap"):
        super().__init__()
        self.model = model
        self.matcher_impl = matcher_impl

    def forward(self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None):
        return compute_losses(self.model, batch, generator, self.matcher_impl)


def ddp_applies() -> bool:
    """Whether a step goes through DDP: under a process group, unless the
    mesh's gradient axis (data x seq) has one rank of several processes
    (tensor parallelism alone: each model rank's gradients are already the
    step's, and the optimizer averages the replicated ones over the model
    axis, `parallel.tp.mean_replicated_grads_`)."""
    size = dist.axis("grad")[1]
    return dist.is_initialized() and (size > 1 or dist.process_count() == 1)


def wrap_ddp(model: GroundingDINO, matcher_impl: str = "lsap") -> DistributedDataParallel:
    """The model's step under DistributedDataParallel, over the mesh's
    gradient axis (`parallel.dist.axis("grad")`: data x seq, every process
    without a mesh). Under sequence parallelism a trainable gradient taken
    on token-sharded activations is a partial sum, and the seq ranks'
    gradients add up to the seq size times the step's (`parallel/sp.py`):
    DDP's mean over data x seq is then the gradient of the global batch's
    loss. Under tensor parallelism each model rank has its own DDP group,
    of the ranks that hold its shards, and the optimizer then averages the
    replicated parameters' gradients over the model axis
    (`parallel.tp.mean_replicated_grads_`). Call after `optim.set_trainable`,
    since DDP hooks only the parameters that require a gradient when it is
    built, and build it anew for each task. It averages the trainable
    gradients over the ranks as the backward makes them, bucket by bucket.
    `find_unused_parameters=True`: which trainable parameters a step leaves
    without a gradient depends on the preset and on the step (CAT's
    `w_noise` gets one only under noisy gating, with a dropout generator),
    which `static_graph` does not allow; the optimizer steps such a
    parameter on zeros."""
    if not ddp_applies():
        raise ValueError("a step needs no DDP here: the mesh's gradient axis (data x seq) "
                         "has one rank, or there is no process group")
    device = next(model.parameters()).device
    return DistributedDataParallel(
        StepLosses(model, matcher_impl),
        device_ids=[device] if device.type == "cuda" else None,
        process_group=dist.axis("grad")[0], find_unused_parameters=True)


def train_step(model: Union[GroundingDINO, DistributedDataParallel], optimizer: Optimizer,
               batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
               matcher_impl: str = "lsap") -> Dict[str, torch.Tensor]:
    """One step; returns the losses and `grad_norm` (the trainable
    gradients' global norm before the clip) as detached tensors on the
    model's device. With the default `matcher_impl="lsap"` the step makes
    no round trip to the host for the matcher. `model` may be `wrap_ddp`'s
    (its own `matcher_impl` then holds): the batch is this rank's slice of
    the global batch, the backward averages the gradients over the ranks
    (but on the calls of an accumulation before its last, which run under
    `no_sync()`), and the losses returned are the global batch's."""
    with profiling.span("step"):
        if isinstance(model, DistributedDataParallel):
            sync = contextlib.nullcontext() if optimizer.will_update() else model.no_sync()
            with sync:
                total, losses = model(batch, generator)
                _backward(total)
            losses = dist.mean_over_ranks(losses)
        else:
            total, losses = compute_losses(model, batch, generator, matcher_impl)
            _backward(total)
        metrics = {k: v.detach() for k, v in losses.items()}
        with profiling.span("step.optimizer"):
            metrics["grad_norm"] = optimizer.step()
    return metrics


def _backward(total: torch.Tensor) -> None:
    if total.requires_grad:
        with profiling.span("step.backward"):
            total.backward()
