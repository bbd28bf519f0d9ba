"""The ZiRa incremental lifecycle, the port of the JAX package's
`train/incremental.py` (reference `train_multidatasets.py:473-561`):

* tasks in sequence, each chaining the weights of the one before (`:473-494`);
* `before_train`: every parameter frozen but the adapters
  (`groundingdino_dual_zero_rep_branch.py:722-737`), in the trainer's setup;
* `after_train`: `rep_merge` of every ZiRa module that has a scaling
  (`:739-745`; as in the JAX package, a repconvbn branch is not folded), then the
  task's class prompts into the prompt memory (`train_multidatasets.py:
  221-228` -> `groundingdino_dt.py:379-437`);
* the prompt memory: per-class text-token embeddings, and the text replay
  that distils the current text features toward them (`groundingdino_dt.py:
  786-838`, driven by `MemoryReplayer`, `train_multidatasets.py:257-312`);
* learned-name caption augmentation (`groundingdino_dt.py:452-460`);
* the final eval of every task, with COCO retention, and the averaged AP
  (`train_multidatasets.py:509-561`).

The chained weights are a state dict (`IncrementalState.params`); the one
model is loaded from it for each task, each eval and the replay phase.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ziragroundingdino_torch.models.groundingdino import GroundingDINO, TextEncoderOnly
from ziragroundingdino_torch.models.zira import rep_merge, scale_reset_for_cfg
from ziragroundingdino_torch.parallel import dist, tp
from ziragroundingdino_torch.text.tokenizer import TextBatch, WordPieceTokenizer, tokenize_captions
from ziragroundingdino_torch.train.optim import ZIRA_TRAINABLE_PATTERNS, set_trainable
from ziragroundingdino_torch.train.trainer import save_atomically

logger = logging.getLogger("ziragroundingdino_torch")


# ---------------------------------------------------------------------------
# prompt memory
# ---------------------------------------------------------------------------


def _class_caption(tokenizer: WordPieceTokenizer, class_names: Sequence[str], max_text_len: int,
                   device: torch.device) -> Tuple[TextBatch, Dict[str, torch.Tensor]]:
    caption = ".".join(class_names) + "."
    tb = tokenize_captions(tokenizer, [caption], max_text_len=max_text_len,
                           max_categories=max(len(class_names), 1))
    return tb, {k: torch.from_numpy(v).to(device) for k, v in tb.asdict().items()}


def encode_class_tokens(model: GroundingDINO, tokenizer: WordPieceTokenizer,
                        class_names: Sequence[str], max_text_len: int = 256):
    """The text path on '.'.join(classes) + '.': (encoded_text [T, E] f32,
    cate_to_token_mask [C, T], the text batch) of the one caption."""
    device = next(model.parameters()).device
    tb, text = _class_caption(tokenizer, class_names, max_text_len, device)
    with torch.no_grad():
        encoded, _ = TextEncoderOnly(model)(text, train=False)
    return encoded[0].float().cpu().numpy(), tb.cate_to_token_mask[0], tb


def add_cls_prompt(prompt_memory: Dict[str, np.ndarray], model: GroundingDINO,
                   tokenizer: WordPieceTokenizer, class_names: Sequence[str],
                   max_text_len: int = 256) -> Dict[str, np.ndarray]:
    """Store each new class's token embeddings under "-name-" (classes
    already in the pool keep theirs, `groundingdino_dt.py:424-432`)."""
    encoded, c2t, _ = encode_class_tokens(model, tokenizer, class_names, max_text_len)
    for i, name in enumerate(class_names):
        key = f"-{name}-"
        if key not in prompt_memory:
            prompt_memory[key] = encoded[c2t[i]]
    return prompt_memory


def replay_memory_loss(model: GroundingDINO, tokenizer: WordPieceTokenizer,
                       learned_classes: Sequence[str], prompt_memory: Dict[str, np.ndarray],
                       max_text_len: int = 256) -> Dict[str, torch.Tensor]:
    """Data-free text replay (`groundingdino_dt.py:786-838`): half the mean
    L1 distance between the current text features of the learned class
    names and their stored embeddings, over the stored positions only (the
    others count 0 and get no gradient), plus the language branch's ZIL.
    Differentiable in the model's parameters."""
    device = next(model.parameters()).device
    tb, text = _class_caption(tokenizer, learned_classes, max_text_len, device)
    t, e = tb.input_ids.shape[1], model.cfg.hidden_dim
    target = np.zeros((t, e), np.float32)
    replace = np.zeros((t,), bool)
    c2t = tb.cate_to_token_mask[0]
    for i, name in enumerate(learned_classes):
        stored = prompt_memory.get(f"-{name}-")
        if stored is not None:
            pos = np.flatnonzero(c2t[i])
            n = min(len(pos), len(stored))
            target[pos[:n]] = stored[:n]
            replace[pos[:n]] = True
    encoded, adapter_loss = TextEncoderOnly(model)(text, train=True)
    encoded = encoded[0].float()
    replace_t = torch.from_numpy(replace).to(device)[:, None]
    diff = torch.where(replace_t, encoded - torch.from_numpy(target).to(device), 0.0)
    losses = {"loss_prompt_memory": diff.abs().mean() * 0.5}
    if model.cfg.use_zero_inter_loss:
        losses["loss_adapter_text"] = adapter_loss * model.cfg.loss_adapter_weight
    return losses


def build_prompt_injection(prompt_memory: Dict[str, np.ndarray],
                           category_names: Sequence[Sequence[str]],  # per batch row
                           cate_to_token_mask: np.ndarray,  # [B, C, T]
                           hidden_dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """(values [B, T, E], mask [B, T]) that put the stored embeddings of
    learned classes in place of their token features at inference
    (`groundingdino_dt.py:521-531`): the model's `prompt_replace_values` /
    `prompt_replace_mask`."""
    b, c, t = cate_to_token_mask.shape
    values = np.zeros((b, t, hidden_dim), np.float32)
    mask = np.zeros((b, t), bool)
    for bi, names in enumerate(category_names):
        for ci, name in enumerate(names[:c]):
            stored = prompt_memory.get(f"-{name}-")
            if stored is None:
                continue
            pos = np.flatnonzero(cate_to_token_mask[bi, ci])
            n = min(len(pos), len(stored))
            values[bi, pos[:n]] = stored[:n]
            mask[bi, pos[:n]] = True
    return values, mask


def augment_caption_with_learned_names(category_names: Sequence[str],
                                       learned_classes: Sequence[str], num_select: int = 20,
                                       rng: Optional[np.random.RandomState] = None) -> List[str]:
    """use_add_names / use_learned_names (`groundingdino_dt.py:452-460`):
    the task's categories, then up to `num_select` learned class names not
    among them (drawn with `rng` when there are more)."""
    extra = [c for c in learned_classes if c not in category_names]
    if rng is not None and len(extra) > num_select:
        extra = list(rng.choice(extra, num_select, replace=False))
    else:
        extra = extra[:num_select]
    return list(category_names) + extra


# ---------------------------------------------------------------------------
# the incremental loop
# ---------------------------------------------------------------------------


@dataclass
class TaskSpec:
    name: str
    train_loader_fn: Callable  # (start_batch=0) -> iterable of batches
    eval_fn: Callable  # (state dict) -> metrics with "AP"
    class_names: List[str] = field(default_factory=list)
    max_iter: int = 2000


@dataclass
class IncrementalState:
    params: Dict[str, torch.Tensor]  # the chained model's state dict
    prompt_memory: Dict[str, np.ndarray] = field(default_factory=dict)
    learned_classes: List[str] = field(default_factory=list)
    per_task_results: List[Dict] = field(default_factory=list)


def snapshot(model: GroundingDINO) -> Dict[str, torch.Tensor]:
    """A copy of the model's state dict, on its device."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def save_incremental_state(path: str, state: IncrementalState) -> str:
    """{params, prompt_memory} with `torch.save` (the reference's
    task-chained model_final.pth with its prompt_memory_pool entries,
    `groundingdino_dual_zero_rep_branch.py:700-711`; each stored embedding
    its own tensor, since their lengths differ), and the learned classes in
    `path + ".classes.json"`."""
    payload = {"params": state.params,
               "prompt_memory": {k: torch.from_numpy(np.asarray(v))
                                 for k, v in state.prompt_memory.items()}}
    save_atomically(payload, path)
    with open(path + ".classes.json.tmp", "w") as f:
        json.dump(state.learned_classes, f)
    os.replace(path + ".classes.json.tmp", path + ".classes.json")
    return path


def load_incremental_state(path: str, device: Optional[torch.device] = None) -> IncrementalState:
    restored = torch.load(path, map_location=device, weights_only=True)
    learned: List[str] = []
    if os.path.exists(path + ".classes.json"):
        with open(path + ".classes.json") as f:
            learned = json.load(f)
    return IncrementalState(
        params=restored["params"],
        prompt_memory={k: v.cpu().numpy() for k, v in restored["prompt_memory"].items()},
        learned_classes=learned)


def run_task(state: IncrementalState, task: TaskSpec, model: GroundingDINO,
             make_trainer: Callable, tokenizer: WordPieceTokenizer) -> IncrementalState:
    """One incremental step: train the task with the base frozen, merge the
    side branches, capture the task's prompts. `make_trainer(params, task)`
    loads `params` into `model` and returns (trainer, extract), `extract()`
    the state dict to chain (the raw or the EMA weights). Resumes from the
    task's newest mid-task checkpoint (`train_net.py:298-305`); the loader's
    fast-forward keeps the data stream aligned. The merge comes before the
    prompt capture and before the next task: in eval a rep module runs its
    freeze branch only. Under data parallelism every rank runs it: the
    trainer reduces the gradients, and the merge and the capture are
    deterministic, so the ranks' states stay equal; the caller saves on
    rank 0."""
    trainer, extract = make_trainer(state.params, task)
    start = trainer.resume_or_load()
    if start:
        logger.info("task %s: resuming at iter %d", task.name, start)
    trainer.train(start, task.max_iter)
    trainer.close()
    model.load_state_dict(extract())
    # the scaling resets to the config's inits, not the library default
    rep_merge(model, scale_reset=scale_reset_for_cfg(model.cfg))
    state.prompt_memory = add_cls_prompt(state.prompt_memory, model, tokenizer, task.class_names,
                                         max_text_len=model.cfg.max_text_len)
    for c in task.class_names:
        if c not in state.learned_classes:
            state.learned_classes.append(c)
    state.params = snapshot(model)
    return state


def run_replay_phase(state: IncrementalState, model: GroundingDINO,
                     tokenizer: WordPieceTokenizer, iters: int = 100, lr: float = 1e-4,
                     image_batch_fn: Optional[Callable] = None,
                     image_loss_fn: Optional[Callable] = None) -> IncrementalState:
    """The MemoryReplayer phase (`train_multidatasets.py:257-312`): after
    the task sequence, train the adapters against `replay_memory_loss` with
    AdamW at optax.adamw's defaults (weight decay 1e-4, eps 1e-8; every
    adapter decays, gradient or not), then merge as after a task. The
    replay trains the "adapter" parameters whatever the preset, as the JAX
    package's (`freeze_all=True`); a model with none (`finetune`,
    `prompttune`, ...) computes the losses and changes nothing.

    The reference's COCO-replay configuration passes both hooks: each
    iteration calls `image_batch_fn()`, and where it returns a batch,
    `image_loss_fn(model, batch)` (a scalar tensor, e.g. `train.step.
    compute_losses`' total with the caller's dropout generator) joins the
    text loss. An iteration whose batch is None is text-only."""
    if not state.learned_classes:
        return state
    model.load_state_dict(state.params)
    set_trainable(model, ZIRA_TRAINABLE_PATTERNS, freeze_all=True)
    params = [p for p in model.parameters() if p.requires_grad]
    opt = (torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
           if params else None)
    learned = list(state.learned_classes)
    cfg = model.cfg
    for it in range(iters):
        batch = image_batch_fn() if image_batch_fn is not None else None
        losses = replay_memory_loss(model, tokenizer, learned, state.prompt_memory,
                                    cfg.max_text_len)
        total = sum(losses.values())
        if image_loss_fn is not None and batch is not None:
            total = total + image_loss_fn(model, batch)
        # a model without a language branch has no text gradient: its image
        # loss, where there is one, carries the graph of the sum
        if total.requires_grad:
            total.backward()
        if opt is not None:
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            # under sequence parallelism an image loss's gradients are the
            # seq ranks' shares (`parallel/sp.py`); the text loss's are equal;
            # the model and pipe ranks' copies of a weight take one update
            dist.mean_over_ranks_([p.grad for p in params], "seq")
            tp.mean_replicated_grads_(params)
            opt.step()
            opt.zero_grad(set_to_none=True)
        if (it + 1) % 20 == 0 or it == 0:
            logger.info("replay iter %d loss %.6f", it + 1, float(total.detach()))
    rep_merge(model, scale_reset=scale_reset_for_cfg(cfg))
    # every rank replays alone: rank 0's result for all of them
    dist.broadcast_module_(model)
    state.params = snapshot(model)
    return state


def final_report(state: IncrementalState, tasks: Sequence[TaskSpec],
                 coco_eval_fn: Optional[Callable] = None) -> Dict[str, float]:
    """`train_multidatasets.py:509-561`: every task's AP, their mean, and the
    COCO zero-shot AP (retention) where `coco_eval_fn` is given. Under data
    parallelism every rank calls it (the evals are sharded) and gets rank
    0's report."""
    aps = []
    report: Dict[str, float] = {}
    for task in tasks:
        res = task.eval_fn(state.params)
        report[f"AP/{task.name}"] = res["AP"]
        aps.append(res["AP"])
        state.per_task_results.append({task.name: res})
    report["avg_AP"] = float(np.mean(aps)) if aps else float("nan")
    if coco_eval_fn is not None:
        report["coco_zero_shot_AP"] = coco_eval_fn(state.params)["AP"]
    logger.info("incremental final: %s", report)
    return report
