"""The check of a run, and its control: the plain reference on the same
inputs and the same seeded weights, run once the program's state is freed,
on the run's device. See `benchmark/lib/compare.py` for the numbers.

`run_check(run, state)` compares what the run's timed path produced.
`control_numbers(run, state)` puts the reference, computed in fp8 where the
configuration states bf16, in the program's place on the same inputs and
compares it the same way: what `benchmark/control.py` reads.
"""

from __future__ import annotations

import contextlib
import sys
from typing import Callable, Dict

import numpy as np
import torch

from benchmark.lib import compare
from benchmark.lib.train import iteration_generator
from benchmark.reference import model as R
from benchmark.reference import precision
from benchmark.reference import train as RT


def _reference(run, state: Callable[[], Dict[str, torch.Tensor]]):
    precision.strict_f32()
    ref = R.build(R.RefConfig.from_file(run.conf), run.device)
    ref.load_state_dict(state(), strict=True)
    return ref


def _detections(logits, boxes, c2t, orig, k):
    return R.detections(R.per_category(logits, c2t), boxes, orig, k)


def _merge(into: Dict[str, float], new: Dict[str, float]) -> None:
    for k, v in new.items():
        into[k] = max(into.get(k, 0.0), v)


# ---------------------------------------------------------------- serving
def serve_numbers(run, state, control: bool = False) -> Dict[str, float]:
    ref = _reference(run, state)
    k = run.mix["predictor"]["select_k"]
    numbers: Dict[str, float] = {}
    with torch.no_grad():
        for s in run.samples:
            px, mask, text, orig, n = run.reference_inputs(s.request)
            recorded, results = s.recorded, s.results
            if control:
                with precision.control():
                    out = ref(px, mask, text)
                recorded = {key: out[key] for key in ("topk_idx", "pred_logits", "pred_boxes",
                                                      "memory", "memory_text")}
                sc, lab, box = _detections(out["pred_logits"], out["pred_boxes"],
                                           text["cate_to_token_mask"], orig, k)
                results = [{"scores": sc[i].cpu().numpy(), "labels": lab[i].cpu().numpy(),
                            "boxes": box[i].cpu().numpy()} for i in range(n)]
            out = ref(px, mask, text, topk_idx=recorded["topk_idx"].to(run.device))

            def head_scores(memory, memory_text, out=out, text=text):
                return ref.selection_scores(memory, memory_text, out["memory_mask"],
                                            out["shapes"], text["text_token_mask"])[2]

            one = compare.serve_numbers(recorded, results, out, text, n, _detections, orig, k,
                                        head_scores)
            print(f"request {s.index}: labels {[len(l) for l in s.request.labels]} tokens "
                  f"{int(text['text_token_mask'][:n].sum())}; "
                  + ", ".join(f"{a} {b:.4g}" for a, b in one.items()), file=sys.stderr)
            _merge(numbers, one)
    numbers["window_captures"] = float(run.keys_after - run.keys_before)
    return numbers


# ---------------------------------------------------------------- training
def step_generator(run, k: int):
    """What the program's step k drew its dropout from: the iteration's
    generator, or on a data mesh (the traffic's `ranks`) each rank's, over
    its rows of the batch."""
    ranks = run.mix.get("ranks", 1)
    if ranks == 1:
        return iteration_generator(run.seed, k, run.device)
    from benchmark.lib.ddp import rank_generator

    return R.ShardGenerators([rank_generator(run.seed, k, r, run.device) for r in range(ranks)],
                             run.mix["batch"] // ranks)


def _reference_steps(run, ref, topk=None, matched=None, fault: str = None):
    """Three reference steps on the run's first three batches: (losses,
    first clipped gradients, changes, each step's selection and
    assignments, and the widest selection and match gaps of the given
    ones). With `topk` / `matched` (per step) the steps follow that
    selection and those assignments. `fault`: "half-batch", a step that
    leaves out half of each batch and takes the mean over the rest;
    "own-shard", rank 0 of a data mesh stepping on its own rows alone (the
    exchange between the ranks left out)."""
    tc = run.conf["train"]
    o = tc["optimizer"]
    ref.configure(enc_checkpoint=True).train()
    params = {n: p for n, p in ref.named_parameters()
              if any(t in n for t in tc["trainable"])}
    for p in ref.parameters():
        p.requires_grad_(False)
    for p in params.values():
        p.requires_grad_(True)
    opt = RT.AdamW(params, o["lr"], tuple(o["betas"]), o["weight_decay"],
                   [tuple(x) for x in o["lr_factors"]])
    before = {n: p.detach().clone() for n, p in params.items()}
    losses, grads, selections, assignments = [], None, [], []
    gaps = {"select_gap": 0.0, "match_gap": 0.0}
    law = run.conf["model"]["loss_adapter_weight"]
    for k in range(run.mix["check"]["steps"]):
        images = run.cycle[k]
        if fault == "half-batch":
            images = images[:len(images) // 2]
        elif fault == "own-shard":
            images = images[:len(images) // run.mix.get("ranks", 1)]
        px, mask, batch = run.reference_batch(images)
        gen = step_generator(run, k)
        # the program's selection, where it selected for this batch
        sel = (topk[k].to(run.device) if topk is not None and k < len(topk)
               and topk[k].shape[0] == px.shape[0] else None)
        out = ref(px, mask, batch, train=True, gen=gen, topk_idx=sel)
        selections.append(out["topk_idx"].detach())
        given = None
        if sel is not None:
            step_gap = max(compare.selection_gap(out["enc_scores"][i].detach(), sel[i])
                           for i in range(sel.shape[0]))
            gaps["select_gap"] = max(gaps["select_gap"], step_gap)
            gaps[f"select_gap_{k + 1}"] = step_gap
            if matched is not None and k < len(matched):
                given = matched[k].to(run.device).chunk(len(out["aux_outputs"]) + 2)
        total, used, gap = RT.total_loss(out, batch, law, given)
        if given is not None:
            gaps["match_gap"] = max(gaps["match_gap"], gap["match_gap"])
            for name, v in gap.items():
                gaps[f"{name}_{k + 1}"] = v
        assignments.append(torch.cat(used))
        total.backward()
        del out
        RT.clip_([p.grad for p in params.values()], o["grad_clip"])
        if k == 0:
            grads = {n: p.grad.detach().clone() for n, p in params.items()}
        losses.append(float(total.detach()))
        opt.step()
    change = {n: p.detach() - before[n] for n, p in params.items()}
    return losses, grads, change, selections, assignments, gaps


def train_numbers(run, state, control: bool = False, fault: str = None) -> Dict[str, float]:
    ref = _reference(run, state)
    if control or fault:
        with precision.control() if control else contextlib.nullcontext():
            p_losses, p_grads, p_change, topk, matched, _ = _reference_steps(run, ref,
                                                                             fault=fault)
        ref = _reference(run, state)
    else:
        c = run.check
        p_losses = [float(x) for x in c["losses"]]
        p_grads, p_change, topk, matched = c["grads"], c["change"], c["topk"], c["matched"]
    losses, grads, change, _, _, gaps = _reference_steps(run, ref, topk, matched)
    keep = compare.kept_leaves(grads)
    dev = run.device
    g = compare.leaf_gaps({k: v.to(dev) for k, v in p_grads.items()}, grads, keep)
    u = compare.leaf_gaps({k: v.to(dev) for k, v in p_change.items()}, change, keep)
    for what, rows in (("gradient", g), ("change", u)):
        for gap, name, a, b in rows[:3]:
            print(f"leaf {what} {name}: program {a!r} reference {b!r} gap {gap!r}",
                  file=sys.stderr)
    print(f"losses: program {p_losses} reference {losses}", file=sys.stderr)
    return {
        "loss_gap": max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(p_losses, losses)),
        "grad_gap": float(np.median([row[0] for row in g])),
        "update_gap": float(np.median([row[0] for row in u])),
        "update_worst": u[0][0],
        "unmoved": float(sum(1 for _, _, a, b in u if a == 0.0 and b > 0.0)),
        **gaps,
        **getattr(run, "rank_numbers", {}),
    }


def run_check(run, state) -> Dict[str, float]:
    if run.mix["kind"] == "serve":
        return serve_numbers(run, state)
    return train_numbers(run, state)


def control_numbers(run, state, fault: str = None) -> Dict[str, float]:
    """The control's numbers, or with `fault` a planted fault's (the
    reference put in the program's place with that fault)."""
    if run.mix["kind"] == "serve":
        return serve_numbers(run, state, control=True)
    return train_numbers(run, state, control=fault is None, fault=fault)
