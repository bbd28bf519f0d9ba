"""Trainable-parameter selection, AdamW with per-parameter lr factors, the lr
schedules, the global-norm clip and EMA: the port of the JAX package's
`train/optim.py` (reference `config/configs/common/optim.py:16-28`,
`coco_schedule.py:91-125`, `common_schedule.py:15-184`, `util/ema.py`).

The frozen base gets `requires_grad=False` (the reference's before_train
hook, `groundingdino_dual_zero_rep_branch.py:722-737`), so neither the
backward nor the optimizer touches it, and the clip sees trainable
gradients only (`train_net.py:144-150`). `torch.optim.AdamW` is the same
update as the JAX package's AdamW (b1, b2, eps 1e-8, decoupled weight decay
scaled by the lr); the schedule is a `LambdaLR` factor, read at the step
count before the step as the JAX schedule is.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ziragroundingdino_torch.config import OptimizerConfig, ScheduleConfig

# the reference's 'unfreeze "adapter"-named params'; the port's parameter
# names use the same vocabulary (rep_linear_adapter, input_proj_conv_adapter)
ZIRA_TRAINABLE_PATTERNS = ("adapter",)


def trainable_patterns_for_cfg(cfg) -> Tuple[str, ...]:
    """The reference's before_train unfreeze matrix (`groundingdino_dt.py:
    775-783`): "adapter" always, plus the module groups of the PET
    baselines' switches (`use_bert_tuning`, `use_cls_linear`,
    `use_project_tuning`), which a config without them leaves off. For the
    ZiRa family that is every parameter of the branches, the freeze
    branches (soft-frozen by an lr factor) and the multilayer variant's
    `freeze_gn` included; ZeroConvBN's running statistics are buffers, not
    parameters. The vanilla `groundingdino` has no such parameter: it
    serves only, and `Optimizer` refuses it."""
    pats = ["adapter"]
    if getattr(cfg, "use_bert_tuning", False):
        pats += ["bert", "feat_map"]
    if getattr(cfg, "use_cls_linear", False):
        pats += ["class_embed", "bbox_embed"]
    if getattr(cfg, "use_project_tuning", False):
        pats += ["input_proj"]
    return tuple(pats)


def trainable_mask(model: nn.Module, patterns: Sequence[str]) -> Dict[str, bool]:
    """{parameter name: trainable}: a substring match on the name, as the
    reference's `if "adapter" in name` loops."""
    return {n: any(p in n for p in patterns) for n, _ in model.named_parameters()}


def set_trainable(model: nn.Module, patterns: Sequence[str]) -> None:
    """`requires_grad` per `trainable_mask`."""
    mask = trainable_mask(model, patterns)
    for n, p in model.named_parameters():
        p.requires_grad_(mask[n])


def lr_factor_fn(lr_factors: Tuple[Tuple[str, float], ...]) -> Callable[[str], float]:
    """The product of the factors whose pattern is in the parameter name."""

    def fn(name: str) -> float:
        f = 1.0
        for pat, factor in lr_factors:
            if pat in name:
                f *= factor
        return f

    return fn


def make_schedule(cfg: ScheduleConfig) -> Callable[[int], float]:
    """lr factor at a step count: "multistep" (x gamma from each milestone
    on), "cosine" (to 0 at max_iter), "linear" (to 0), "constant",
    "exponential" (gamma ** (step / max_iter)); with warmup_iter > 0 a
    linear ramp from warmup_factor to 1 first, then the schedule from 0."""
    n = cfg.max_iter
    if cfg.name == "multistep":
        bounds = sorted({int(round(f * n)) for f in cfg.milestones_frac})

        def sched(step):
            return cfg.gamma ** sum(step >= b for b in bounds)
    elif cfg.name == "cosine":
        def sched(step):
            return 0.5 * (1.0 + math.cos(math.pi * min(step, n) / n))
    elif cfg.name == "linear":
        def sched(step):
            return 1.0 - min(max(step, 0), n) / n
    elif cfg.name == "constant":
        def sched(step):
            return 1.0
    elif cfg.name == "exponential":
        def sched(step):
            return cfg.gamma ** (step / n)
    else:
        raise ValueError(f"unknown schedule {cfg.name!r}")
    if cfg.warmup_iter <= 0:
        return sched
    w, f0 = cfg.warmup_iter, cfg.warmup_factor

    def warmed(step):
        if step < w:
            return f0 + (1.0 - f0) * step / w
        return sched(step - w)

    return warmed


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale the gradients in place by min(1, max_norm / ||g||), ||g|| the
    global L2 norm over all of them, and return ||g|| (as the JAX package's
    clip: no epsilon is added to the norm, unlike `clip_grad_norm_`)."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    if max_norm:
        scale = torch.clamp(max_norm / norm, max=1.0)
        for g in grads:
            g.mul_(scale)
    return norm


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               decay: float = 0.999) -> None:
    """ema = decay * ema + (1 - decay) * params, in place (`util/ema.py`)."""
    for n, e in ema.items():
        e.mul_(decay).add_(params[n].detach(), alpha=1.0 - decay)


class Optimizer:
    """What one train step applies to the trainable parameters of `model`
    (those with `requires_grad`): the global-norm clip, AdamW with one
    parameter group per lr factor, the schedule, and an EMA of the
    trainable parameters when `ema_decay` is given."""

    def __init__(self, model: nn.Module, cfg: OptimizerConfig = OptimizerConfig(),
                 schedule: ScheduleConfig = ScheduleConfig(), ema_decay: Optional[float] = None):
        if cfg.name != "adamw":
            raise ValueError(f"the port's optimizer is adamw, not {cfg.name!r}")
        self.params = {n: p for n, p in model.named_parameters() if p.requires_grad}
        if not self.params:
            raise ValueError("the model has no trainable parameter")
        factor = lr_factor_fn(cfg.lr_factors)
        groups: Dict[float, list] = {}
        for n, p in self.params.items():
            groups.setdefault(factor(n), []).append(p)
        self.adamw = torch.optim.AdamW(
            [{"params": ps, "lr": cfg.lr * f} for f, ps in sorted(groups.items())],
            lr=cfg.lr, betas=cfg.betas, eps=1e-8, weight_decay=cfg.weight_decay)
        self.schedule = torch.optim.lr_scheduler.LambdaLR(self.adamw, make_schedule(schedule))
        self.grad_clip = cfg.grad_clip
        self.ema_decay = ema_decay
        self.ema = (None if ema_decay is None
                    else {n: p.detach().clone() for n, p in self.params.items()})

    def step(self) -> torch.Tensor:
        """Apply the gradients that the backward left on the trainable
        parameters, then clear them. Returns their global norm before the
        clip."""
        grads = [p.grad for p in self.params.values() if p.grad is not None]
        if not grads:
            raise RuntimeError("no trainable parameter has a gradient")
        norm = clip_by_global_norm_(grads, self.grad_clip)
        self.adamw.step()
        self.schedule.step()
        if self.ema is not None:
            ema_update(self.ema, self.params, self.ema_decay)
        self.adamw.zero_grad(set_to_none=True)
        return norm

    def state_dict(self) -> Dict:
        """AdamW's moments and step counts, the schedule's step and the EMA:
        what a checkpoint needs to resume (`torch.load(weights_only=True)`
        reads it back)."""
        return {"adamw": self.adamw.state_dict(), "schedule": self.schedule.state_dict(),
                "ema": self.ema}

    def load_state_dict(self, state: Dict) -> None:
        """Restore `state_dict()` of an Optimizer built the same way."""
        self.adamw.load_state_dict(state["adamw"])
        self.schedule.load_state_dict(state["schedule"])
        if (self.ema is None) != (state["ema"] is None):
            raise ValueError("the checkpoint's EMA does not match this optimizer's")
        if self.ema is not None:
            with torch.no_grad():
                for n, e in self.ema.items():
                    e.copy_(state["ema"][n])
