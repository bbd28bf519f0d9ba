"""Trainable-parameter selection, AdamW with per-parameter lr factors, the lr
schedules, the global-norm clip and EMA: the port of the JAX package's
`train/optim.py` (reference `config/configs/common/optim.py:16-28`,
`coco_schedule.py:91-125`, `common_schedule.py:15-184`, `util/ema.py`).

The frozen base gets `requires_grad=False` (the reference's before_train
hook, `groundingdino_dual_zero_rep_branch.py:722-737`), so neither the
backward nor the optimizer touches it, and the clip sees trainable
gradients only (`train_net.py:144-150`). With `freeze_all=False` (the
`finetune` preset) every parameter trains. `torch.optim.AdamW` is the same
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
from ziragroundingdino_torch.parallel import dist, tp

# the reference's 'unfreeze "adapter"-named params'; the port's parameter
# names use the same vocabulary (rep_linear_adapter, input_proj_conv_adapter)
ZIRA_TRAINABLE_PATTERNS = ("adapter",)


def trainable_patterns_for_cfg(cfg) -> Tuple[str, ...]:
    """The reference's before_train unfreeze matrix (`groundingdino_dt.py:
    775-783`): "adapter" always, plus the module groups of the PET
    baselines' switches (`use_bert_tuning`, `use_cls_linear`,
    `use_project_tuning`). For the
    ZiRa family that is every parameter of the branches, the freeze
    branches (soft-frozen by an lr factor) and the multilayer variant's
    `freeze_gn` included; ZeroConvBN's running statistics are buffers, not
    parameters. CAT's are its in-layer and prompt adapters, the dt model's
    its CET adapter. `use_prompt_tuning` adds nothing: the JAX package
    keeps the prompts outside the parameters and never optimises them, so
    `prompttune` (like the vanilla `groundingdino`) has no trainable
    parameter and its steps change no weight."""
    pats = ["adapter"]
    if cfg.use_bert_tuning:
        pats += ["bert", "feat_map"]
    if cfg.use_cls_linear:
        pats += ["class_embed", "bbox_embed"]
    if cfg.use_project_tuning:
        pats += ["input_proj"]
    return tuple(pats)


def trainable_mask(model: nn.Module, patterns: Sequence[str],
                   freeze_all: bool = True) -> Dict[str, bool]:
    """{parameter name: trainable}: a substring match on the name, as the
    reference's `if "adapter" in name` loops; every parameter with
    `freeze_all=False` (`GroundingDINO_SwinT_OGC_dt_finetuning.py`)."""
    return {n: not freeze_all or any(p in n for p in patterns)
            for n, _ in model.named_parameters()}


def set_trainable(model: nn.Module, patterns: Sequence[str], freeze_all: bool = True) -> None:
    """`requires_grad` per `trainable_mask`."""
    mask = trainable_mask(model, patterns, freeze_all)
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
def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float,
                         sharded: Sequence[bool] = ()) -> torch.Tensor:
    """Scale the gradients in place by min(1, max_norm / ||g||), ||g|| the
    global L2 norm over all of them, and return ||g|| (as the JAX package's
    clip: no epsilon is added to the norm, unlike `clip_grad_norm_`). Under
    tensor parallelism a gradient flagged in `sharded` is this model rank's
    shard of one: their squares are summed over the model axis, so each
    shard counts once and each replicated gradient once."""
    norms = torch.stack([torch.linalg.vector_norm(g) for g in grads])
    if any(sharded):
        flag = torch.tensor(list(sharded), device=norms.device)
        group = dist.axis("model")[0]
        tp_sq = dist.reduced(norms[flag].square().sum(), group)
        norm = torch.sqrt(norms[~flag].square().sum() + tp_sq)
    else:
        norm = torch.linalg.vector_norm(norms)
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


def _whole(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """A tensor shaped as parameter `p`, whole where `p` is a tensor-parallel
    shard (a collective over the model axis): what a checkpoint holds."""
    return p.tp.full_of(t) if tp.is_sharded(p) else t


def _local(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """`_whole`'s inverse: this model rank's slice of a checkpoint's tensor."""
    return p.tp.local_of(t) if tp.is_sharded(p) else t


class Optimizer:
    """What one train step applies to the trainable parameters of `model`
    (those with `requires_grad`): the global-norm clip, AdamW with one
    parameter group per lr factor, the schedule, and an EMA of the
    trainable parameters when `ema_decay` is given. A model with no
    trainable parameter takes steps that change nothing, as the JAX
    package's optimizer does under an all-frozen mask.

    `batch_size_scale` = k > 1 accumulates gradients over k calls, as
    `optax.MultiSteps(every_k_schedule=k)` does in the JAX package
    (`train/optim.py:170-171`; the reference's `train_net.py:128-140`): the
    backward adds each call's gradients into `.grad` (under DDP the first
    k - 1 calls run under `no_sync()`, so the k-th reduces the sum), and the
    k-th call applies the clip, AdamW and the schedule to their mean; the
    schedule's count advances once per k calls. The EMA moves on every
    call, as the JAX step's does after each `apply_updates` (a zero update
    on the k - 1 calls between)."""

    def __init__(self, model: nn.Module, cfg: OptimizerConfig = OptimizerConfig(),
                 schedule: ScheduleConfig = ScheduleConfig(), ema_decay: Optional[float] = None,
                 batch_size_scale: int = 1):
        if cfg.name != "adamw":
            raise ValueError(f"the port's optimizer is adamw, not {cfg.name!r}")
        if batch_size_scale < 1:
            raise ValueError(f"batch_size_scale {batch_size_scale} must be at least 1")
        self.batch_size_scale = batch_size_scale
        self.mini_step = 0  # calls accumulated since the last update
        self.params = {n: p for n, p in model.named_parameters() if p.requires_grad}
        self.device = next(model.parameters()).device
        # AdamW's state keys: the parameters' places in its groups
        self._by_index: Dict[int, torch.Tensor] = {}
        factor = lr_factor_fn(cfg.lr_factors)
        groups: Dict[float, list] = {}
        for n, p in self.params.items():
            groups.setdefault(factor(n), []).append(p)
        self.adamw = self.schedule = None
        if self.params:
            self.adamw = torch.optim.AdamW(
                [{"params": ps, "lr": cfg.lr * f} for f, ps in sorted(groups.items())],
                lr=cfg.lr, betas=cfg.betas, eps=1e-8, weight_decay=cfg.weight_decay)
            self._by_index = dict(enumerate(p for g in self.adamw.param_groups
                                            for p in g["params"]))
            self.schedule = torch.optim.lr_scheduler.LambdaLR(self.adamw,
                                                              make_schedule(schedule))
        self.grad_clip = cfg.grad_clip
        self.ema_decay = ema_decay
        self.ema = (None if ema_decay is None
                    else {n: p.detach().clone() for n, p in self.params.items()})

    def will_update(self) -> bool:
        """Whether the next `step()` applies an update (the k-th call of an
        accumulation; every call when `batch_size_scale` is 1)."""
        return self.mini_step + 1 >= self.batch_size_scale

    def step(self) -> torch.Tensor:
        """Apply the gradients that the backward left on the trainable
        parameters, then clear them; with `batch_size_scale` > 1 keep them
        until the k-th call. Returns the global norm before the clip of the
        gradient that is applied (between updates: of the mean gradient so
        far); 0 without a trainable parameter."""
        if not self.params:
            return torch.zeros((), device=self.device)
        if all(p.grad is None for p in self.params.values()):
            raise RuntimeError("no trainable parameter has a gradient")
        for p in self.params.values():
            if p.grad is None:
                # a trainable parameter the loss did not reach (CAT's `w_noise`
                # without noisy gating) steps on a zero gradient, so that AdamW
                # decays it and its moments as optax's does
                p.grad = torch.zeros_like(p)
        # the model and pipe ranks' copies of a parameter take one update
        tp.mean_replicated_grads_(self.params.values())
        grads = [p.grad for p in self.params.values()]
        sharded = [tp.is_sharded(p) for p in self.params.values()]
        self.mini_step += 1
        if self.mini_step < self.batch_size_scale:
            norm = clip_by_global_norm_([g / self.mini_step for g in grads], 0.0, sharded)
        else:
            if self.batch_size_scale > 1:
                for g in grads:
                    g.div_(self.batch_size_scale)
            norm = clip_by_global_norm_(grads, self.grad_clip, sharded)
            self.adamw.step()
            self.schedule.step()
            self.adamw.zero_grad(set_to_none=True)
            self.mini_step = 0
        if self.ema is not None:
            ema_update(self.ema, self.params, self.ema_decay)
        return norm

    def _reduced_accumulation(self) -> Dict[str, torch.Tensor]:
        """The gradients accumulated so far, averaged over the ranks in place
        (under DDP the calls between updates keep each rank's own sum; the
        k-th call's reduction averages them in any case, so averaging them
        earlier changes no update, and every rank then holds what a
        checkpoint holds)."""
        for p in self.params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        dist.mean_over_ranks_([p.grad for p in self.params.values()])
        return {n: _whole(p, p.grad.detach().clone()) for n, p in self.params.items()}

    def state_dict(self) -> Dict:
        """AdamW's moments and step counts, the schedule's step and the EMA:
        what a checkpoint needs to resume (`torch.load(weights_only=True)`
        reads it back); with `batch_size_scale` > 1 also the accumulation
        (the calls since the last update and their gradients), so that a
        checkpoint taken between updates resumes bitwise. Under DDP every
        rank calls it at once (`_reduced_accumulation`)."""
        ema = (None if self.ema is None
               else {n: _whole(self.params[n], e) for n, e in self.ema.items()})
        if not self.params:
            return {"adamw": None, "schedule": None, "ema": ema}
        adamw = self.adamw.state_dict()
        adamw["state"] = {i: {k: _whole(self._by_index[i], v) if k != "step" else v
                              for k, v in st.items()} for i, st in adamw["state"].items()}
        state = {"adamw": adamw, "schedule": self.schedule.state_dict(), "ema": ema}
        if self.batch_size_scale > 1:
            state["accumulation"] = {"mini_step": self.mini_step,
                                     "grads": self._reduced_accumulation()
                                     if self.mini_step else None}
        return state

    def load_state_dict(self, state: Dict) -> None:
        """Restore `state_dict()` of an Optimizer built the same way."""
        if self.adamw is not None:
            adamw = dict(state["adamw"])
            adamw["state"] = {int(i): {k: _local(self._by_index[int(i)], v) if k != "step" else v
                                       for k, v in st.items()}
                              for i, st in adamw["state"].items()}
            self.adamw.load_state_dict(adamw)
            self.schedule.load_state_dict(state["schedule"])
        if self.batch_size_scale > 1:
            acc = state["accumulation"]
            self.mini_step = acc["mini_step"]
            for n, p in self.params.items():
                p.grad = None if acc["grads"] is None else _local(p, acc["grads"][n]).clone()
        if (self.ema is None) != (state["ema"] is None):
            raise ValueError("the checkpoint's EMA does not match this optimizer's")
        if self.ema is not None:
            with torch.no_grad():
                for n, e in self.ema.items():
                    e.copy_(_local(self.params[n], state["ema"][n]))
