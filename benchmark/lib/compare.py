"""The comparison that decides `correct`, and its numbers. A cell's limits
file (`benchmark/limits/<cell>.json`) names the numbers it compares; the
others are printed with their readings, since no control reading stands
three times above the program's (see PERF.md).

Serving. The program's bf16 selection of 900 queries out of ~20k encoder
tokens and its f32 reference part on near-tied scores, and a query whose
slot changes meets another learned query embedding: detections of the two
would then differ without a fault. So the check follows the program's own
selection (the reference's decoder runs on it) and checks the start and
the selection by themselves:
  * `memory_gap`: the encoder's outputs, the image memory (valid tokens)
    and the text (valid tokens), recorded from the program's graph, against
    the reference's own encoder on the same image and caption: the larger
    root mean square of the difference over the reference's;
  * `head_miss` / `head_gap`: the program's selection against the
    reference's two-stage head run on the program's own encoder outputs: the
    share that the head does not rank among its best 900, and the widest
    inversion over the scores' standard deviation (`selection_gap`);
  * `select_gap` / `select_miss`: the program's ordered selection against
    the reference's scores from the reference's own encoder: the widest
    inversion over the scores' standard deviation, and the share missed;
  * `logit_gap` / `box_gap`: the program's `pred_logits` (valid tokens) and
    `pred_boxes` of all 900 queries against the reference's decoder run on
    the program's selection: root mean square of the difference, in logit
    units and in image fractions (over the logits' spread instead, a
    1-label caption's few tokens read 7 times a long caption's);
  * `post_gap`: the Predictor's returned top-k (scores, labels, boxes in
    original pixels) against the reference's post-processing (per-category
    max, sigmoid, top-k, scaling) of the program's own `pred_logits` and
    `pred_boxes`: the largest difference of a score, a label (1 when they
    differ) or a box coordinate in pixels. The same arithmetic on the same
    numbers: exact.

Training. The reference follows the program's query selection and its
matcher's assignments (both recorded per step, so that near-tied queries
and near-tied matches part neither side); dropout masks come from the same
per-step generators, drawn in the same order (bitwise equal at f32 on the
CPU, `tests/test_bench_reference.py`):
  * `loss_gap`: the largest relative difference of the total loss over the
    first three steps;
  * `grad_gap`: per leaf |‖g‖ - ‖g_ref‖| / max(‖g_ref‖, the median leaf's
    ‖g_ref‖), g the clipped first gradient as AdamW got it (its first
    moment after one step over 1 - beta1); the median leaf's. The worst
    leaf is a branch's `scaling`, a scalar whose gradient is one sum over
    every image token with much cancellation: its gap swings from seed to
    seed as widely as the control's, so it is printed;
  * `update_gap`: the median leaf's gap of the change over the three
    steps; `update_worst` the worst leaf's. A branch's `scaling` is one
    element whose gradient cancels over every image token: AdamW moves it
    about lr a step by that gradient's sign, which the program's rounding
    can turn, so the worst leaf swings from seed to seed as `grad_gap`'s
    does;
  * `unmoved`: the leaves that the reference moves and the program leaves
    exactly where they were (a `scaling` left out of the update among
    them): 0 in a sound run;
  * `select_gap`: as serving's, of the program's selection in each of the
    three steps against the reference's selection scores in that step
    (`select_gap_<k>` each step's, printed);
  * `match_gap` (printed, not compared): the program's assignments against
    the exact optimum of the reference's costs, the assignment's total cost
    above the optimum's, over the sum of the optimum's |costs|, the widest
    over outputs, images and steps; `match_gap_<k>` each step's, and
    `match_spread_<k>` each step's over the sum of the targets' cost
    spreads instead. A sum of |costs| can lie near 0, and from step 2 the
    two sides' weights differ: neither separates sound runs from the fp8
    control (see PERF.md);
  * `rank_gap` (a data mesh): the largest difference of any rank's first
    gradient or change from rank 0's, over the largest magnitude of rank
    0's: exactly 0 where DDP hands every rank one average.
  Leaves whose reference gradient is under a thousandth of the median
  leaf's are left out of both leaf gaps (none of the ZiRa cells' leaves is).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch


def selection_gap(scores: torch.Tensor, selected: torch.Tensor) -> float:
    """scores [S] (reference), selected [Q] (program's order) -> the gap
    over the scores' standard deviation."""
    r = scores.double()
    q = selected.numel()
    sel = r[selected.long()]
    boundary = torch.topk(r, q).values[-1] - sel.min()
    run_min = torch.cummin(sel, 0).values
    inversion = (sel[1:] - run_min[:-1]).max() if q > 1 else torch.zeros((), dtype=r.dtype)
    gap = torch.clamp(torch.maximum(boundary, inversion), min=0.0)
    return float(gap / r.std().clamp(min=1e-30))


def selection_miss(scores: torch.Tensor, selected: torch.Tensor) -> float:
    """The share of the program's selection that the reference's scores do
    not rank among their own best as many (ties to the lower index)."""
    q = selected.numel()
    best = torch.sort(scores, descending=True, stable=True).indices[:q]
    return float(1.0 - torch.isin(selected.long(), best).double().mean())


def rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).square().mean().sqrt() / b.square().mean().sqrt().clamp(min=1e-30))


def serve_numbers(recorded: Dict[str, torch.Tensor], results: List[Dict[str, np.ndarray]],
                  ref_out: Dict, text: Dict[str, torch.Tensor], n: int, detections_fn,
                  orig: torch.Tensor, select_k: int, head_scores) -> Dict[str, float]:
    """The numbers of one request (`n` real images of its batch).
    `head_scores(memory, memory_text)` is the reference's two-stage head's
    selection scores on given encoder outputs."""
    dev = ref_out["pred_logits"].device
    # the start: the encoder's image memory (valid tokens) and text (valid tokens)
    s = ref_out["memory"].shape[1]
    mem = recorded["memory"][:, :s].to(dev).float()
    mtext = recorded["memory_text"][:, :text["text_token_mask"].shape[1]].to(dev).float()
    mm, tm = ref_out["memory_mask"][:n], text["text_token_mask"][:n]
    memory_gap = max(rel_rms(mem[:n][mm], ref_out["memory"][:n][mm]),
                     rel_rms(mtext[:n][tm], ref_out["memory_text"][:n][tm]))
    # the selection by itself: the program's against the reference's head on the
    # program's own encoder outputs
    own = head_scores(mem, mtext)
    head_miss = max(selection_miss(own[i], recorded["topk_idx"][i].to(dev)) for i in range(n))
    head_gap = max(selection_gap(own[i], recorded["topk_idx"][i].to(dev)) for i in range(n))
    t = text["text_token_mask"].shape[1]
    valid = text["text_token_mask"][:n]
    p_log = recorded["pred_logits"][:n, :, :t].to(dev).double()
    r_log = ref_out["pred_logits"][:n, :, :t].double()
    m = valid[:, None, :].expand_as(p_log)
    logit_gap = float((p_log - r_log)[m].square().mean().sqrt())
    p_box = recorded["pred_boxes"][:n].to(dev).double()
    box_gap = float((p_box - ref_out["pred_boxes"][:n].double()).square().mean().sqrt())
    sel = max(selection_gap(ref_out["enc_scores"][i], recorded["topk_idx"][i].to(dev))
              for i in range(n))
    miss = max(selection_miss(ref_out["enc_scores"][i], recorded["topk_idx"][i].to(dev))
               for i in range(n))
    # post-processing of the program's own outputs by the reference
    scores, labels, boxes = detections_fn(recorded["pred_logits"].to(dev),
                                          recorded["pred_boxes"].to(dev),
                                          text["cate_to_token_mask"], orig, select_k)
    post = 0.0
    for i in range(n):
        got = results[i]
        k = len(got["scores"])
        if k != scores.shape[1]:
            post = max(post, float("inf"))
            continue
        post = max(post,
                   float(np.abs(got["scores"] - scores[i].cpu().numpy()).max(initial=0.0)),
                   float((got["labels"] != labels[i].cpu().numpy()).any()),
                   float(np.abs(got["boxes"] - boxes[i].cpu().numpy()).max(initial=0.0)))
    return {"memory_gap": memory_gap, "head_miss": head_miss, "head_gap": head_gap,
            "select_gap": sel,
            "select_miss": miss, "logit_gap": logit_gap, "box_gap": box_gap, "post_gap": post}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: Sequence[str]) -> List[tuple]:
    """Per leaf (gap, name, ‖a‖, ‖b‖), worst first: gap = |‖a‖ - ‖b‖| /
    max(‖b‖, the median leaf's ‖b‖)."""
    pn = {k: float(torch.linalg.vector_norm(prog[k].double())) for k in keep}
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keep}
    med = float(np.median(list(rn.values())))
    return sorted(((abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30), k, pn[k], rn[k])
                   for k in keep), reverse=True)


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             keep: Sequence[str]) -> float:
    """The worst leaf's gap (`leaf_gaps`)."""
    return leaf_gaps(prog, ref, keep)[0][0]


def kept_leaves(ref_grads: Dict[str, torch.Tensor]) -> List[str]:
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref_grads.items()}
    med = float(np.median(list(norms.values())))
    return [k for k, v in norms.items() if v >= 1e-3 * med]
