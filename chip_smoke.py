"""Drive the PyTorch port on one NVIDIA card and check it.

    python3 chip_smoke.py [--profile DIR] [--phase3c | --phase3d | --phase12 | --phase13 |
                           --phase14]

Phases, in order (any failure raises, and the script exits non-zero):
  1. card: name, nvidia-smi name and power limit; TF32 off for f32 checks;
  2. build: every CUDA kernel of the port (`msda_forward`, `msda_backward`,
     `lsap`), from its sources, one nvcc each, all at once; each kernel's registers,
     stack frame and spills as ptxas reports them, and a failure if any
     kernel has a stack frame or spills;
  3. kernels vs plain: `msda_forward` against `ms_deform_attn_plain` on the
     card at the encoder shape (Q = S = 20197 at 800x1216), the decoder shape
     (Q = 900), a tail shape (Q = 901: the last block's tile is ragged), an
     edge shape (B = 2, locations exactly 0, exactly 1 and far outside) and a
     ragged shape (D = 16, B = 2, odd levels, locations in [-0.1, 1.1]), a
     hot shape (Q = 4096, every sample of level 3 in one cell), f32
     and bf16 value, with timings (CUDA events, median of 20): `ms`, the
     call time (events around the Python call, so the host's time before
     the launch counts, as the first slice timed it) and `device_ms` (a
     spin before the first event hides the host's time, so only the kernel
     counts); at the encoder shape also the device time with L2 flushed
     before every launch; the wrapper's host time per call;
  3b. the same for `msda_backward` against `ms_deform_attn_backward_plain`
     (all three gradients), both paths at every shape (the binned passes,
     which calls from `BINNED_MIN_SAMPLES` samples on take, and the
     single-pass kernel of smaller calls; each forced through
     `BINNED_MIN_SAMPLES`), with what the binned design moves (L2 gather,
     records, g re-reads, flush atomics; modelled, so only in the log) beside
     the bytes bound, at the encoder and decoder shapes one call's launches
     (count, scan, records, main, accumulate, memset, cast) under
     torch.profiler, and both paths' device time at Q between the decoder's
     and the encoder's (where the binned passes overtake the single pass);
  3c. the exact assignment: `lsap` against `lsap_plain` at P = 7 * B
     problems (the train step's 7 outputs of B images, B = 1, 2), Q = 900,
     N = 1, 5, 50, 100 and Q, integer costs (ties), half the targets at BIG,
     Q = 901, and the lifecycle's padding (N = max_boxes = 100, 5 and 30
     valid targets, the rest BIG): assignments exactly equal, totals equal
     to scipy's, one launch a call; the call and device time, the host scipy
     path's time, the bytes bound, and at N = 5, 100 and the padded shape
     the latency bound (`lsap_latency_bound`, with PR 8's beside it);
  3d. the fusion layers' attention core: `fusion_attention` (the kernel
     family of `csrc/fusion_attn.cu`) against `fusion_attention_plain` at
     serve-coco's request (B = 2, Nv = 20197, Nl = 256) and the ODinW
     requests' (B = 1, Nl = 32 and 64, Nv of the 800x1216 and 800x1344
     buckets), 4 heads of 256, bf16, image and text masks partly set, each
     call followed by a synchronise: call and device ms (as phase 3), the
     bound (inputs read once, outputs written once, the three products), the
     share of it, the plain version's ms, and as `library_ms` the parent's
     path (bf16 logits, `.float()`, masked fills, the strided softmax over
     Nv, the casts, the transposed product), timed here and never called by
     the port; each kernel's device time under torch.profiler;
  4. whole model, card vs CPU: a reduced-depth f32 model (tiny Swin/BERT,
     2 + 2 layers) with the same seeded weights on both;
  4b. the same model's train step, card vs CPU: every loss and every
     trainable gradient, the assignments of the CPU's matcher replayed on
     the card (near-ties may flip), so the backward kernel runs inside the
     model;
  5. main path: `dualzerorepbranchgroundingdino` at full width (Swin-T,
     BERT-base, 6 + 6 layers, 900 queries, bf16) answers `predict` requests
     on a synthetic 800x1216 image; every request must launch the MSDA
     kernel 12 times (6 encoder + 6 decoder layers), the fusion kernel family
     6 times (one a fusion layer) and MSDA's backward never;
     with --profile, where the time of those requests goes (`phase_profile`);
  5b. train path: the same model takes 4 `train_step`s on that image with a
     4-category caption and 5 seeded boxes, dropout at the preset's rates
     from a CUDA generator: finite losses, 12 `msda_forward` and 12
     `msda_backward` launches per step (the 6 encoder calls by the binned
     passes, the 6 decoder calls by the single-pass kernel), frozen weights
     unchanged, every ZiRa branch given a gradient that is not all zero by
     the backward and moved, one `lsap` launch a step and no host matcher
     call; ms per step and peak memory; then warm steps with
     `matcher_impl="scipy"` and `"lsap"` in turns, and each one's
     synchronising calls under `torch.cuda.set_sync_debug_mode("warn")`;
     with --profile, a step's device busy time, idle share and top kernels;
  6. the ZiRa lifecycle at full width: the port's ODinW driver
     (`ziragroundingdino_torch.scripts.train_odinw.main`) on a seeded
     reference-format checkpoint with a prompt memory and two synthetic
     ODinW tasks (3 and 2 classes, 600x800 PPM originals): 4 train steps a
     task at batch 2 with learned-name captions and a checkpoint every 2,
     the merge, the prompt capture, 2 replay iterations, the eval of both
     tasks; `train_odinw` trains with remat on, as JAX's: 18 `msda_forward`
     launches per train step (12, and the 6 encoder layers recomputed in
     the backward) and 12 per eval batch, 12 `msda_backward` per train step
     (6 binned), the plain MSDA never;
     after each merge every non-ZiRa tensor unchanged, each freeze branch
     the trained freeze + scaling * branch, the branches and scalings
     reset, the checkpoint's prompt memory in the chain; on an eval batch
     of task A the encoder's memory and the encoded text before the merge
     (train mode) and after it (eval) within MERGE_BF16_TOL; a finite
     report, and a second run that restores both tasks and reports the
     same; the stages' times and the peak memory;
  7. the released model and the rest of the ZiRa family at full width:
     7a. a seeded reference-format checkpoint of the vanilla `groundingdino`
       (no ZiRa key) through `load_model(..., preset="groundingdino")`, 4
       `predict` requests on a PPM of phase 5's image (12 `msda_forward`
       launches each), and the port's demo
       (`scripts/inference_on_a_image.main`) on it: its JSON holds
       `predict`'s boxes, and it writes the annotated PPM;
     7b. the same checkpoint into `dualzerorepbranchgroundingdino`: the
       ZiRa keys and nothing else missing, nothing unexpected, and the same
       detections as 7a (eval runs only the zero freeze branches);
     7c. `repgroundingdino`, `dualzerorepmultilayerbranchgroundingdino`,
       `repconvbngroundingdino` and the LoRA language branch, each with
       seeded ZiRa weights: 2 train steps on phase 5b's batch (12 + 12
       launches a step, 6 binned), the merge (`rep_merge`, and
       `rep_merge_convbn` for the BN variant): non-ZiRa tensors unchanged,
       each freeze tensor the formula of its kind, and for the repconv and
       LoRA configurations eval after the merge against train mode before
       it on the batch; the warm step, peak memory and merge time;
  8. the PET baselines and CAT at full width:
     8a. each of `dtgroundingdino`, `finetune`, `linearprobe`, `prompttune`,
       `berttune`, `projecttune` and `catgroundingdino`, its zero-init
       adapter and MoE weights seeded: one `predict` request on phase 5's
       image (12 `msda_forward` launches), 2 train steps with dropout on
       phase 5b's batch (24 `msda_forward` launches, and 24 `msda_backward`
       with 12 binned where a gradient reaches MSDA: not in `linearprobe`,
       whose trainable heads sit after the decoder, nor in `prompttune`,
       which trains nothing), finite losses (CAT's `loss_adapter` > 0),
       frozen weights bitwise unchanged, every trainable one given a
       gradient that is not all zero by the backward (but ZERO_GRADIENT's,
       0 by construction: CAT's one-expert MoE gate, BERT's key biases;
       the box heads' zero-init last layers seeded) and moved (Swin's and BERT's in
       `finetune`; none in `prompttune`);
     8b. `scripts/train_odinw.main --preset dtgroundingdino` on phase 6's
       two synthetic tasks, 2 steps each (remat on: 18 `msda_forward`
       launches a step), the second task's caption with the first's
       classes, prompt capture and eval: only the CET adapter changes; a
       `phase 8: {...}` line with each preset's request ms, warm step ms,
       peak memory and launches;
  9. the Predictor (`utils/predictor.py`) at full width: (a) phase 5's
     image with a 4-category caption, batch 1, 8 requests; (b) three images
     of three sizes with three captions, batch bucket 4; (c) 8 images; (d)
     a caption of over 64 tokens (text bucket 128). Per key one CUDA graph,
     captured once with 12 `msda_forward` launches inside, its replay
     against the eager forward of the same inputs, request ms and img/s;
     (a) against `predict`; the peak memory with every graph alive and the
     shared pool; with --profile a replayed request's idle share; a
     `phase 9: {...}` line, with phase 5b's matcher comparison;
  10. every architecture switch of the JAX model at full width (BERT-base,
     d = 256, 6 + 6 layers, 900 queries, bf16, 800x1216), seeded weights in
     the reference's format under `build/phase10` (removed after):
     10a. GroundingDINO-B: a vanilla Swin-B-384 checkpoint (window 12)
       through `load_model(..., backbone="swin_B_384_22k")` with no key
       missing, unexpected or mismatched, 4 `predict` requests (12
       launches each), the demo with `--config-overrides` (its detections
       `predict`'s), one Predictor key (batch 1, text bucket 32): one
       capture of 12 launches, the replay bitwise the eager forward; with
       --profile, where a request's time goes (`swin_b_trace.json.gz`);
     10b. that checkpoint loaded non-strictly into the ZiRa preset three
       times, remat off, off again and on, its branches seeded alike: the same first step
       with dropout from one generator seed, losses bitwise equal, every
       trainable gradient within REMAT_GRAD_TOL of its scale (a second
       step without remat gives the floor of the atomics), 12 against
       18 `msda_forward` launches and 12 `msda_backward` (6 binned) each,
       step ms and peak each way; then phase 7c's 2 steps and merge with
       remat on;
     10c. the ZiRa preset on ResNet-50 with learned positions: one
       request, phase 7c's 2 steps and merge; one `finetune` step in
       which the frozen BN's four tensors (53 BNs) and the learned tables
       get a gradient and move, as in JAX;
     10d. the vanilla model on Swin-L 384: one request and its peak;
     10e. one request each with `use_text_enhancer`, `use_fusion_layer`,
       `use_text_cross_attention`, `embed_init_tgt` and
       `sub_sentence_present` off: finite detections, the parameter count
       lower by exactly what the switch removes;
     10f. `train_odinw --config-overrides` (Swin-B) from the vanilla
       Swin-B checkpoint on phase 6's tasks, 2 steps each, remat on by
       default (the config it built checked), merge and eval: only ZiRa
       tensors change; a `phase 10: {...}` line;
  11. data parallelism (`parallel/`, `train_odinw` / `eval_coco --mesh`), the
     ZiRa preset at full width from phase 6's seeded checkpoint and tasks
     under `build/phase11` (removed after); the ranks are processes of
     `torch.distributed.run` (this script with --phase11-worker), so this
     process joins no group, and the kernels are built before they start:
     11a. `train_odinw --mesh 1` on one rank over NCCL, 2 tasks x 2 steps at
       batch 2 with remat, merge and sharded eval, against the plain run
       here on the same seed: the first step's losses bitwise equal, every
       trainable gradient within REMAT_GRAD_TOL of its scale, the eval's
       images in the same order with as many detections each; 18
       `msda_forward`, 12 `msda_backward` and 1 `lsap` launches a step both
       ways; a step's NCCL all-reduces under torch.profiler (at least one
       per DDP bucket), the run's steps and 12 warm steps each way with
       and without DDP in turns, peak memory;
     11b. two ranks sharing the card over gloo (NCCL refuses two ranks on
       one device), in f32 (DP_DTYPE: bf16 ties in the random weights' query
       selection make an image's decoder queries depend on the batch size):
       DDP steps at global batch 2 (an image a rank; unrelated images,
       captions of 4 and 2 categories, 5 and 2 targets) of the ZiRa and
       repconvbn presets against this process at batch 2. Each step twice:
       the ranks choosing their queries and matching for themselves
       (losses within DP_TOL relative, every trainable gradient within
       DP_TOL of its scale), and replaying the batch-2 run's choice and
       assignments (DP_PINNED_TOL); the repconvbn branches' batch
       statistics (global: a synchronised BN) and ZeroConvBN outputs
       within DP_STATS_TOL; a local `num_boxes` must miss by more than
       DP_TOL. Then `eval_coco --mesh 2` on task A's 3 test images (the last
       global batch padded) against `eval_coco`: the same images in order,
       the same detections, the same AP;
     11c. `batch_size_scale=2` over two micro-steps of one image against
       one step at batch 2 (halves of equal counts): AdamW and the schedule
       step once, the EMA twice, the trainable tensors within DP_TOL of
       their scale, one `lsap` launch a call; a `phase 11: {...}` line.
  12. the replay's image hooks, few-shot, the other metrics and
     `load_image`, from phase 6's seeded checkpoint and tasks under
     `build/phase12` (removed after):
     12a. `run_replay_phase` with `image_batch_fn` / `image_loss_fn` (the
       reference's COCO-replay configuration), remat on: 3 iterations, an
       800x1216 batch (4 categories, 5 boxes) on the first two and None on
       the third, the driver's detection loss with dropout: 18
       `msda_forward`, 12 `msda_backward` (6 binned) and 1 `lsap` launch
       per image iteration, none in the text-only one; frozen tensors
       bitwise unchanged, every adapter given a gradient and moved, the
       merge held as phase 6's; the first image iteration again in f32
       from the same state and generator seed, through the kernels and
       through `ms_deform_attn_plain`: the total loss within
       REPLAY_LOSS_TOL, the adapter gradients within REMAT_GRAD_TOL;
     12b. the port's `write_fewshot_json` for both tasks, then
       `train_odinw --shot 1shot`, 2 steps a task: the trained sets are
       `fewshot_subset`'s, the report's keys, the launches;
     12c. a task image through `utils.inference.load_image` and `predict`,
       bitwise the `data.transforms` route; 12b's eval detections of the
       first task scored by `VocMeanAP` and `LvisMeanAP` beside
       `CocoMeanAP`, each finite and in [0, 1]; a `phase 12: {...}` line.
  13. tensor and sequence parallelism (`parallel/tp.py`, `parallel/sp.py`,
     `train_odinw --mesh D,M,S`), the ZiRa preset at full width (Swin-T,
     BERT-base, d = 256, 6 + 6 layers, 900 queries, f32, remat on) from
     phase 6's seeded checkpoint and tasks under `build/phase13` (removed
     after), the ranks processes of `torch.distributed.run` sharing the card
     over gloo (this script with --phase13-worker); no scaling is claimed:
     13a. `make_mesh(1, 2)` (TP), two ranks, after a probe of the port's
       collectives on f32 and bf16 card tensors (PORT_COLLECTIVES; one
       that gloo refuses fails the phase, named): a request and two AdamW
       steps at batch 2 against this process at batch 2, the query choice
       and the assignments replayed as 11b's: the first step's losses
       within DP_PINNED_TOL[0], every trainable gradient within
       DP_PINNED_TOL[1] of its scale, the request's logits and boxes within
       REQUEST_TOL, each TP-sharded weight at half its element count on
       each rank, the sharded model's `state_dict()` bitwise the one
       process's weights, the replicated trainable weights bitwise alike on
       every rank after the steps; 18, 12 and 1 launches a step and 12
       `msda_forward` a request on each rank;
     13b. `make_mesh(1, 1, 2)` (SP): the same checks; each rank's encoder
       `msda_forward` launched with its chunk of the 20197 queries against
       the whole value table, the decoder's with 450 of 900 queries, and
       the first such launch equal to `ms_deform_attn_plain` within F32_TOL;
     13c. `train_odinw --mesh 1,2,2` on four ranks, 2 tasks x 2 steps, the
       merge and the eval, against the plain run here: the first step's
       losses and gradients within DP_TOL (each run chooses its own queries
       and assignments, as 11b's), the replicated weights bitwise alike
       on every rank after each step, the chained states' untrained tensors
       bitwise and trained ones within CHAIN_TOL (AdamW's floor), the same
       images in the same order with as many detections, their scores and
       boxes within CHAIN_EVAL_TOL, the merge held by `check_zira_merge`,
       18, 12 and 1 launches a step on every rank;
     each rank's peak memory and step ms beside one process's; a
     `phase 13: {...}` line.
  14. pipeline parallelism over the encoder's layers (`parallel/pp.py`,
     `pipeline_parallel(make_mesh(..., pipe=2), microbatches=2)`) at full
     width, f32, remat on, under `build/phase14` (removed after), the ranks
     processes of `torch.distributed.run` sharing the card over gloo (this
     script with --phase14-worker); no scaling is claimed:
     14a. the ZiRa preset under `make_mesh(1, pipe=2)`, two ranks of 3
       encoder layers each; 14b. CAT (stage-owned in-layer adapters, its
       adapter loss across the stages) under `make_mesh(1, model=2,
       pipe=2)`, four ranks; each a request and two AdamW steps at batch 2
       against this process at batch 2, the query choice and assignments
       replayed: the first step's losses within DP_PINNED_TOL[0], every
       trainable gradient as the update takes it within DP_PINNED_TOL[1]
       of its scale, the request within REQUEST_TOL, every rank's weights
       and `state_dict()` bitwise alike after the steps; on each rank 18,
       12 (6 binned) and 1 launches a step and 12 `msda_forward` a
       request, its own stage's layers alone, 4 transfers a neighbouring
       stage and 2 broadcasts over the pipe line a step; each rank's step
       ms and peak memory beside one process's; a `phase 14: {...}` line.
  Phases 5b, 6, 7c, 8, 10, 11, 12, 13 and 14 check one `lsap` launch a
  train step, and 5b to 12 no host matcher call (no copy of the costs to
  the host).
  15. result: a `kernels` JSON line, the nvidia-smi line, and last
     `{"ok": true, "device": {...}}`.

It needs a CUDA card and the repository's `ziragroundingdino_torch` package
next to it; without either it fails before printing a result.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
ENC_SHAPES = ((100, 152), (50, 76), (25, 38), (13, 19))  # levels at 800x1216
ENC_S = sum(h * w for h, w in ENC_SHAPES)  # 20197
RAGGED_SHAPES = ((7, 9), (5, 3), (2, 11), (1, 1))
EDGES = (0.0, 1.0, -7.5, 8.25)  # locations of the "edges" case, beside uniform ones
HOT_CELL = (6, 9)  # (y, x) of the level-3 cell of the "hot" case
L2_FLUSH_BYTES = 128 * 2**20  # written between launches for a cold-L2 time (L2: 50 MB)
SPIN_CYCLES = 1_000_000  # ~0.5 ms at the H100's clock: the host enqueues a timed call meanwhile
F32_TOL = 1e-5  # times max(1, max |plain|): f32 summation order over L*P*4 terms
BF16_REL_TOL = 1e-2  # bf16 kernel vs plain in f32 on the same bf16 inputs
MODEL_TOL = 1e-3  # card vs CPU, f32 reduced-depth model (GEMM/conv order)
# backward kernel vs plain, times each gradient's max |plain|: f32 order of
# the sums and of the atomic adds; bf16 d_value is rounded once to bf16,
# d_loc and d_attn stay f32 (products of bf16 inputs are exact in f32)
BWD_TOL = {torch.float32: {"d_value": 1e-5, "d_loc": 1e-5, "d_attn": 1e-5},
           torch.bfloat16: {"d_value": 1e-2, "d_loc": 1e-4, "d_attn": 1e-4}}
TRAIN_STEPS = 4


def tpu_kernel_file(name: str = "msda_pallas.py", folder: str = "ops") -> str:
    """Path, in this checkout, of a file of the JAX package: the TPU kernel
    that `msda_forward` replaces (`ops/msda_pallas.py`, `pallas_call` at
    line 72), the MSDA with the hand-written backward that `msda_backward`
    replaces (`ops/msda.py`, the custom VJP at line 617) or the matcher
    whose `lsap_jax` `lsap` replaces (`train/matcher.py`, line 83)."""
    root = pathlib.Path(__file__).resolve().parent
    found = sorted(root.glob(f"*/{folder}/{name}"))
    found = [f for f in found if (f.parent.parent / "ops" / "msda_pallas.py").exists()]
    if len(found) != 1:
        raise FileNotFoundError(f"expected one */ops/{name} under {root}, got {found}")
    return found[0].relative_to(root).as_posix()


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, n: int = 20, warmup: int = 3, flush: torch.Tensor | None = None,
            spin: bool = False) -> float:
    """Median time of `fn` over n runs, each between two CUDA events
    recorded around the call, so the host's time before the launch counts
    (the call time). With `spin`, the stream is first held by a spin of
    about 0.5 ms (`torch.cuda._sleep`) while the host enqueues the first
    event and `fn`, so only the device's time counts for an `fn` whose host
    work fits in the spin (the device time). With `flush`, that buffer is
    written before each run, outside the events, so that `fn` finds L2
    cold."""
    for _ in range(warmup):
        fn()
    times = []
    for i in range(n):
        if flush is not None:
            flush.fill_(i & 0xFF)
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_us(fn, n: int = 200) -> float:
    """Host time per call of `fn`, called n times back to back (a device that
    keeps up leaves only the host's time)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    elapsed = time.perf_counter() - t
    torch.cuda.synchronize()
    return elapsed / n * 1e6


def msda_inputs(shapes, b, q, h, d, dtype, span=(0.0, 1.0), seed=0):
    """Seeded value, loc and attn; loc uniform in span = (lo, hi), or with
    span = "edges" a fifth each of EDGES' four values, the rest in [0, 1], or
    with span = "hot" uniform in [0, 1] but for the last level's, all in
    one cell."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    s = sum(hh * ww for hh, ww in shapes)
    n_levels, n_points = len(shapes), 4
    size = (b, q, h, n_levels, n_points, 2)
    value = torch.randn(b, s, h, d, device="cuda", generator=g).to(dtype)
    loc = torch.rand(size, device="cuda", generator=g)
    if span == "edges":
        pick = torch.randint(0, len(EDGES) + 1, size, device="cuda", generator=g)
        table = torch.tensor(EDGES + (0.0,), device="cuda")
        loc = torch.where(pick < len(EDGES), table[pick], loc)
    elif span == "hot":
        # every sample of the last level inside one cell (HOT_CELL, y and x;
        # x = loc * w - 0.5 in [x + 0.05, x + 0.95]): the backward's bin of
        # that cell splits over many chunks
        h_l, w_l = shapes[-1]
        cy, cx = HOT_CELL
        xy = torch.tensor([cx + 0.55, cy + 0.55], device="cuda")
        loc[:, :, :, -1] = (xy + 0.9 * loc[:, :, :, -1]) / torch.tensor(
            [w_l, h_l], device="cuda")
    else:
        lo, hi = span
        loc = lo + (hi - lo) * loc
    attn = torch.softmax(torch.randn(b, q, h, n_levels * n_points, device="cuda", generator=g),
                         -1).reshape(b, q, h, n_levels, n_points)
    return value, loc, attn


def msda_bound(value, loc, attn, out):
    """Least time for the call: every input read once and the output written
    once at the memory rate, or its arithmetic at the f32 rate (2 flops per
    channel per corner sample, plus ~20 per sample for the corner weights).
    Also returns the bytes the corner gather reads from L2 (4 corners of D
    channels per sample), a second figure beside the bound."""
    nbytes = sum(t.numel() * t.element_size() for t in (value, loc, attn, out))
    b, q, h, n_levels, n_points, _ = loc.shape
    d = value.shape[-1]
    samples = b * q * h * n_levels * n_points
    flops = samples * (4 * 2 * d + 20)
    gather_bytes = samples * 4 * d * value.element_size()
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes,
            gather_bytes)


def msda_backward_bound(value, loc, attn, grad_out):
    """Least time for the backward: value, loc, attn and grad_out read once,
    the function's outputs written once (d_value in the value's dtype, d_loc
    and d_attn in f32), at the memory rate, or its arithmetic at the f32 rate
    (per corner 2 flops per channel for the dot with g and 2 for d_value's
    product and add, plus ~40 per sample)."""
    nbytes = sum(t.numel() * t.element_size() for t in (value, loc, attn, grad_out))
    nbytes += value.numel() * value.element_size() + 4 * (loc.numel() + attn.numel())
    b, q, h, n_levels, n_points, _ = loc.shape
    d = value.shape[-1]
    flops = b * q * h * n_levels * n_points * (4 * 4 * d + 40)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def binned_traffic(value, shapes, loc, grad_out) -> dict:
    """What the binned passes' design moves for these inputs, modelled with
    the plain copy of the bins (`tests/torch_msda_bins.py`) on the card, for
    the log beside the bound: the main pass's corner gather (from L2), the
    records (16 bytes per binned sample, written and read), the accumulate
    pass's g re-reads (one row per record), its flush's float4 atomic adds
    (at most every window cell inside its level, per chunk: a cell whose sum
    is 0 adds nothing) with their count, and the f32 d_value accumulator
    (zeroed, added into, read by the cast once each)."""
    import importlib.util

    # by path: a package named `tests` elsewhere on sys.path may shadow this one
    path = pathlib.Path(__file__).resolve().parent / "tests" / "torch_msda_bins.py"
    spec = importlib.util.spec_from_file_location("torch_msda_bins", path)
    bins_ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bins_ref)
    bin_plan, chunk_table = bins_ref.bin_plan, bins_ref.chunk_table
    sample_bins, tile_region = bins_ref.sample_bins, bins_ref.tile_region

    b, q, h, n_levels, n_points, _ = loc.shape
    d = value.shape[-1]
    plan = bin_plan(shapes)
    bins, _ = sample_bins(loc, shapes, plan)
    counts = torch.bincount(bins[bins >= 0], minlength=b * h * plan.n_tiles)
    table = chunk_table(counts)
    cells = torch.tensor([(y1 - y0) * (x1 - x0) for _, y0, y1, x0, x1 in
                          (tile_region(plan, shapes, t, window=True)
                           for t in range(plan.n_tiles))], device=loc.device)
    flush_cells = cells[table[:, 0] % plan.n_tiles].sum().item()
    records = counts.sum().item()
    samples = b * q * h * n_levels * n_points
    return dict(l2_gather_mb=samples * 4 * d * value.element_size() / 1e6,
                records_mb=2 * 16 * records / 1e6,
                g_reread_mb=records * d * grad_out.element_size() / 1e6,
                flush_atomic_mb_at_most=flush_cells * d * 4 / 1e6,
                flush_atomics_at_most=flush_cells * d // 4, chunks=len(table),
                f32_accumulator_mb=4 * value.numel() / 1e6)


def device_launches(fn) -> list:
    """The device activities (kernels, memsets, copies) of one call of `fn`
    under torch.profiler, in the order they ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda e: e.time_range.start)


def launch_breakdown(fn) -> dict:
    """The device time of each launch of one call of `fn` under
    torch.profiler, labelled by pass; returns {label: ms}."""
    kernels = device_launches(fn)
    labels = (("msda_bin_count", "count"), ("msda_bin_scan", "scan"),
              ("msda_bin_records", "records"), ("msda_backward_main", "main"),
              ("msda_backward_accumulate", "accumulate"), ("Memset", "memset"),
              ("FillFunctor", "memset"))
    out = {}
    for e in kernels:
        label = next((lab for key, lab in labels if key in e.name), "cast")
        ms = e.time_range.elapsed_us() / 1e3
        out[label] = out.get(label, 0.0) + ms
        log(f"  {label:10s} {ms * 1e3:9.2f} us  {e.name[:100]}")
    return out


def check_ptxas(name: str, text: str) -> int:
    """Print each kernel's registers, stack frame and spills from the ptxas
    log of `csrc/<name>.cu`; raise if a kernel has a stack frame or spills.
    Returns the number of kernels seen."""
    rows, fn = [], None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            rows.append([fn, *map(int, m.groups()), None])
        m = re.search(r"Used (\d+) registers", line)
        if m and rows:
            rows[-1][-1] = int(m.group(1))
    for fn, frame, stores, loads, regs in rows:
        # ..._GLOBAL__N_..._msda_<file>_cu_...<len><kernel>I<type>Li<D>E[Li<L>ELi<P>E]E...
        names = re.findall(r"(?:msda|lsap|fusion)_[a-z_]+", fn or "")
        kernel = names[-1] if names else fn
        t = re.search(r"I(f|13__nv_bfloat16)Li(\d+)E(?:Li(\d+)ELi\d+E)?", fn or "")
        label = kernel + (f"<{'f32' if t.group(1) == 'f' else 'bf16'}, D={t.group(2)}"
                          + ("" if t.group(3) is None else
                             ", L=P=4" if t.group(3) != "0" else ", generic L, P") + ">"
                          if t else "")
        t = re.search(r"lsap_kernelILi(\d+)E", fn or "")
        if t:  # the instance's columns per thread
            label = f"lsap_kernel<{t.group(1)}>"
        t = re.search(r"fusion_attn_(kernel|combine)ILi(\d+)E(?:Lb(\d)E)?", fn or "")
        if t:  # the instance's head dim, and the pass of the attention kernel
            label = f"fusion_attn_{t.group(1)}<hd={t.group(2)}" + (
                "" if t.group(3) is None else ", text->image" if t.group(3) == "1"
                else ", image->text") + ">"
        log(f"  {name}: {label}: {regs} registers, {frame} bytes stack frame, "
            f"{stores} bytes spill stores, {loads} bytes spill loads")
        if frame or stores or loads:
            raise AssertionError(f"{name}: {label} has a stack frame or spills")
    return len(rows)


# (name, spatial shapes, B, Q, H, D, location span) of phases 3 and 3b
KERNEL_CASES = [
    ("encoder", ENC_SHAPES, 1, ENC_S, 8, 32, (0.0, 1.0)),
    ("decoder", ENC_SHAPES, 1, 900, 8, 32, (0.0, 1.0)),
    ("tail", ENC_SHAPES, 1, 901, 8, 32, (0.0, 1.0)),
    ("edges", ENC_SHAPES, 2, 901, 8, 32, "edges"),
    ("ragged", RAGGED_SHAPES, 2, 37, 3, 16, (-0.1, 1.1)),
    ("hot", ENC_SHAPES, 1, 4096, 8, 32, "hot"),
]
CROSSOVER_Q = (1800, 3600, 7200, 14400)  # phase 3b's sweep of both backward paths


def phase_kernels(msda_forward, ms_deform_attn_plain):
    """Kernel vs plain at the main path's shapes; returns the bf16
    measurements at the encoder and decoder shapes for the kernels line."""
    record = {}
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for name, shapes, b, q, h, d, span in KERNEL_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            value, loc, attn = msda_inputs(shapes, b, q, h, d, dtype, span)
            want = ms_deform_attn_plain(value.float(), shapes, loc, attn)
            scale = max(1.0, want.abs().max().item())
            tol = F32_TOL * scale if dtype == torch.float32 else BF16_REL_TOL * scale

            out = msda_forward(value, shapes, loc, attn)
            torch.cuda.synchronize()
            err = (out.float() - want).abs().max().item()
            if not err <= tol:
                raise AssertionError(f"msda_forward disagrees with the plain version at "
                                     f"{name} {dtype}: {err} > {tol}")
            ms = time_ms(lambda: msda_forward(value, shapes, loc, attn))
            device_ms = time_ms(lambda: msda_forward(value, shapes, loc, attn), spin=True)
            plain_ms = time_ms(lambda: ms_deform_attn_plain(value, shapes, loc, attn))
            bound_ms, bound_by, nbytes, gather_bytes = msda_bound(value, loc, attn, out)
            log(f"msda_forward {name} {str(dtype)[6:]} B={b} Q={q} H={h} D={d} "
                f"max_abs_err={err:.3e} rel_err={err / scale:.3e} tol={tol:.3e} "
                f"call_ms={ms:.4f} device_ms={device_ms:.4f} plain_ms={plain_ms:.4f} "
                f"bound_ms={bound_ms:.4f} ({bound_by}, {nbytes / 1e6:.1f} MB) "
                f"share_of_bound call={bound_ms / ms:.3f} device={bound_ms / device_ms:.3f} "
                f"l2_gather={gather_bytes / 1e6:.1f} MB "
                f"({gather_bytes / device_ms / 1e9:.2f} TB/s over device_ms)")
            if dtype != torch.bfloat16 or name not in ("encoder", "decoder", "ragged"):
                continue
            if name == "ragged":  # a launch of a few microseconds: the call is host time
                record["host_us"] = host_us(lambda: msda_forward(value, shapes, loc, attn))
                log(f"msda_forward host time per call, {record['host_us']:.1f} us (ragged "
                    f"bf16, 200 calls back to back)")
                continue
            record[name] = dict(max_abs_err=err, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by,
                                l2_gather_mb=gather_bytes / 1e6)
            if name == "encoder":
                cold = time_ms(lambda: msda_forward(value, shapes, loc, attn), flush=flush,
                               spin=True)
                record[name]["cold_l2_device_ms"] = cold
                log(f"msda_forward {name} bf16 cold L2 ({L2_FLUSH_BYTES >> 20} MB written "
                    f"before each launch): device_ms={cold:.4f}")
    return record


# (name, B, Nv, Nl) of phase 3d: serve-coco's request, and the ODinW
# requests' at the 800x1216 and 800x1344 buckets (20197 and 22323 tokens)
ENC_S_1344 = 100 * 168 + 50 * 84 + 25 * 42 + 13 * 21
FUSION_CASES = [("coco", 2, ENC_S, 256), ("odinw_t32", 1, ENC_S, 32),
                ("odinw_t64", 1, ENC_S, 64), ("odinw_t32_1344", 1, ENC_S_1344, 32),
                ("odinw_t64_1344", 1, ENC_S_1344, 64)]
FUSION_HEADS, FUSION_HD = 4, 256  # every preset's fusion: embed 1024 over 4 heads
FUSION_REL_TOL = 2e-2  # bf16 outputs; P rounded to bf16 before (kernel) or after (plain) normalising
BF16_FLOPS = 989e12  # H100 SXM bf16 dense, NVIDIA data sheet


def fusion_inputs(b, nv, nl, seed=0):
    """Seeded projections' outputs [B, N, 4 * 256] bf16 (q_v at the scale
    hd**-0.5 gives it) and masks: item 1's last tenth of image tokens
    padded, each item's text valid up to a seeded length."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    e = FUSION_HEADS * FUSION_HD

    def draw(n, scale=1.0):
        return (scale * torch.randn(b, n, e, device="cuda", generator=g)).bfloat16()

    q, k, vv, vl = draw(nv, 2.0 * FUSION_HD ** -0.5), draw(nl), draw(nv), draw(nl)
    mask_v = torch.ones(b, nv, dtype=torch.bool, device="cuda")
    mask_v[1:, nv - nv // 10:] = False
    lengths = torch.randint(nl // 2, nl + 1, (b,), device="cuda", generator=g)
    mask_l = torch.arange(nl, device="cuda")[None] < lengths[:, None]
    return q, k, vv, vl, mask_v, mask_l, FUSION_HEADS


def fusion_bound(b, nv, nl):
    """Least time of the function (ms): q_v, val_v, k_l, val_l and the masks
    read once, out_v and out_l written once at the memory rate, or the three
    products (S, P_v val_l, P_l^T val_v) at the bf16 rate."""
    e = FUSION_HEADS * FUSION_HD
    nbytes = 2 * (3 * b * nv * e + 3 * b * nl * e) + b * (nv + nl)
    flops = 3 * 2 * b * nv * nl * e
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def parent_fusion_core(q, k, vv, vl, mask_v, mask_l, heads):
    """The parent's inline path between the projections (the yardstick): bf16
    logits cast to f32, the masked fills, `softmax(dim=-2)` over Nv (PyTorch's
    strided kernel) and `softmax(dim=-1)`, the casts and both products."""
    b, nv, e = q.shape
    hd = e // heads

    def split(t):
        return t.reshape(t.shape[0], t.shape[1], heads, hd).transpose(1, 2)

    logits = torch.matmul(split(q), split(k).transpose(-1, -2)).float()
    attn_l = torch.softmax(logits.masked_fill(~mask_v[:, None, :, None], -1.0e9), dim=-2)
    attn_v = torch.softmax(logits.masked_fill(~mask_l[:, None, None, :], -1.0e9), dim=-1)
    out_v = torch.matmul(attn_v.to(q.dtype), split(vl))
    out_l = torch.matmul(attn_l.to(q.dtype).transpose(-1, -2), split(vv))
    return (out_v.transpose(1, 2).reshape(b, nv, e),
            out_l.transpose(1, 2).reshape(b, k.shape[1], e))


def phase_fusion_attention(fusion_attn):
    """Phase 3d; returns {case: measurements}."""
    record = {}
    for name, b, nv, nl in FUSION_CASES:
        args = fusion_inputs(b, nv, nl)
        before = fusion_attn.fusion_attention.launches
        got = fusion_attn.fusion_attention(*args)
        torch.cuda.synchronize()
        if fusion_attn.fusion_attention.launches != before + 1:
            raise AssertionError("fusion_attention did not count its launch")
        want = fusion_attn.fusion_attention_plain(*args)
        torch.cuda.synchronize()
        errs = {}
        for what, g_, w_ in zip(("out_v", "out_l"), got, want):
            scale = max(1.0, w_.float().abs().max().item())
            errs[what] = (g_.float() - w_.float()).abs().max().item() / scale
            if not errs[what] <= FUSION_REL_TOL:
                raise AssertionError(f"fusion_attention disagrees with the plain version at "
                                     f"{name}, {what}: {errs[what]} > {FUSION_REL_TOL}")
        del got, want
        ms = time_ms(lambda: fusion_attn.fusion_attention(*args))
        device_ms = time_ms(lambda: fusion_attn.fusion_attention(*args), spin=True)
        plain_ms = time_ms(lambda: fusion_attn.fusion_attention_plain(*args), n=5)
        library_ms = time_ms(lambda: parent_fusion_core(*args), n=5)
        bound_ms, bound_by, nbytes = fusion_bound(b, nv, nl)
        kernels = {}
        for e in device_launches(lambda: fusion_attn.fusion_attention(*args)):
            label = ("combine" if "combine" in e.name else "text_to_image"
                     if "true" in e.name else "image_to_text")
            kernels[label] = kernels.get(label, 0.0) + e.time_range.elapsed_us() / 1e3
        splits = fusion_attn.split_plan(b, FUSION_HEADS, nl, nv)
        record[name] = dict(b=b, nv=nv, nl=nl, rel_err=errs, ms=ms, device_ms=device_ms,
                            bound_ms=bound_ms, bound_by=bound_by, mb=nbytes / 1e6,
                            share_of_bound=bound_ms / device_ms, plain_ms=plain_ms,
                            library_ms=library_ms, kernel_ms=kernels, splits=splits)
        log(f"fusion_attention {name} B={b} Nv={nv} Nl={nl} h={FUSION_HEADS} hd={FUSION_HD} "
            f"rel_err={errs} call_ms={ms:.4f} device_ms={device_ms:.4f} "
            f"bound_ms={bound_ms:.4f} ({bound_by}, {nbytes / 1e6:.1f} MB) share_of_bound "
            f"device={bound_ms / device_ms:.3f} plain_ms={plain_ms:.3f} "
            f"library_ms={library_ms:.3f} kernels_ms={kernels} splits={splits}")
        del args
        torch.cuda.empty_cache()
    return record


@contextlib.contextmanager
def backward_path(msda_cuda, binned: bool):
    """`msda_backward` forced onto one path: the binned passes (from 0
    samples on) or the single-pass kernel (never binned)."""
    keep = msda_cuda.BINNED_MIN_SAMPLES
    msda_cuda.BINNED_MIN_SAMPLES = 0 if binned else 2**62
    try:
        yield
    finally:
        msda_cuda.BINNED_MIN_SAMPLES = keep


def phase_backward(msda_cuda, ms_deform_attn_backward_plain):
    """Backward kernel vs plain backward at phase 3's shapes, both paths (the
    binned passes and the single-pass kernel) at every shape; returns the
    bf16 measurements at the encoder and decoder shapes by path for the
    kernels line. The binned design's modelled traffic is logged beside the
    bound, not returned."""
    msda_backward = msda_cuda.msda_backward
    record = {}
    for name, shapes, b, q, h, d, span in KERNEL_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            value, loc, attn = msda_inputs(shapes, b, q, h, d, dtype, span)
            g = torch.randn(b, q, h * d, device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(1)).to(dtype)
            want = ms_deform_attn_backward_plain(value.float(), shapes, loc, attn, g.float())
            plain_ms = time_ms(lambda: ms_deform_attn_backward_plain(value, shapes, loc, attn, g),
                               n=5, warmup=1)
            bound_ms, bound_by, nbytes = msda_backward_bound(value, loc, attn, g)
            for binned in (True, False):
                path = "binned" if binned else "single_pass"
                with backward_path(msda_cuda, binned):
                    got = msda_backward(value, shapes, loc, attn, g)
                    torch.cuda.synchronize()
                    errs = []
                    for gname, x, w in zip(("d_value", "d_loc", "d_attn"), got, want):
                        scale = max(w.abs().max().item(), 1e-30)
                        err = (x.float() - w).abs().max().item()
                        tol = BWD_TOL[dtype][gname] * scale
                        errs.append(f"{gname} {err:.3e} (scale {scale:.3e}, tol {tol:.3e})")
                        if not err <= tol:
                            raise AssertionError(
                                f"msda_backward ({path}) disagrees with the plain backward at "
                                f"{name} {dtype}, {gname}: {err} > {tol}")
                        if gname == "d_value":
                            d_value_err = err

                    def fn():
                        return msda_backward(value, shapes, loc, attn, g)

                    ms = time_ms(fn)
                    device_ms = time_ms(fn, spin=True)
                    log(f"msda_backward {path} {name} {str(dtype)[6:]} B={b} Q={q} H={h} D={d} "
                        "max_abs_err: " + "; ".join(errs) + f"; call_ms={ms:.4f} "
                        f"device_ms={device_ms:.4f} plain_ms={plain_ms:.4f} "
                        f"bound_ms={bound_ms:.4f} ({bound_by}, {nbytes / 1e6:.1f} MB) "
                        f"share_of_bound call={bound_ms / ms:.3f} "
                        f"device={bound_ms / device_ms:.3f}")
                    if binned:
                        log("  the binned design moves (modelled): " + ", ".join(
                            f"{k}={v:.1f}" if isinstance(v, float) else f"{k}={v}"
                            for k, v in binned_traffic(value, shapes, loc, g).items()))
                    if dtype == torch.bfloat16 and name in ("encoder", "decoder"):
                        record[name, path] = dict(max_abs_err=d_value_err, ms=ms,
                                                  device_ms=device_ms, plain_ms=plain_ms,
                                                  bound_ms=bound_ms, bound_by=bound_by)
                        log(f"msda_backward {path} {name} bf16, one call's launches under "
                            "torch.profiler:")
                        record[name, path]["launch_ms"] = launch_breakdown(fn)
    # where the binned passes overtake the single pass: device ms of both at
    # the encoder's levels, bf16, uniform locations, Q between the decoder's
    # and the encoder's
    for q in CROSSOVER_Q:
        value, loc, attn = msda_inputs(ENC_SHAPES, 1, q, 8, 32, torch.bfloat16)
        g = torch.randn(1, q, 256, device="cuda").to(torch.bfloat16)
        times = {}
        for binned in (True, False):
            with backward_path(msda_cuda, binned):
                times[binned] = time_ms(lambda: msda_backward(value, ENC_SHAPES, loc, attn, g),
                                        spin=True)
        log(f"msda_backward crossover Q={q} ({attn.numel()} samples) bf16 device_ms: binned "
            f"{times[True]:.4f}, single_pass {times[False]:.4f}")
    return record


# ---------------------------------------------------------------------------
# 3c. the exact assignment (the matcher's kernel)
# ---------------------------------------------------------------------------

LSAP_OUTPUTS = 7  # cost matrices per image in a train step: last layer, 5 aux, encoder head
# (name, B, Q, N, kind) of phase 3c: P = LSAP_OUTPUTS * B problems
LSAP_CASES = [
    *[(f"n{n}", b, 900, n, "uniform") for b in (1, 2) for n in (1, 5, 50, 100)],
    *[("square", b, 900, 900, "uniform") for b in (1, 2)],
    *[("integers", b, 900, 50, "integers") for b in (1, 2)],
    *[("big_columns", b, 900, 20, "big_columns") for b in (1, 2)],
    *[("tail", b, 901, 50, "uniform") for b in (1, 2)],
    *[("padded", b, 900, 100, "padded") for b in (1, 2)],
]
LSAP_TIMED = ("n5", 1)  # phase 5b's: its 5 boxes on one image, unpadded
# the lifecycle's: every step pads its targets to max_boxes = 100
# (data/loader.py), image b of the batch with PADDED_VALID[b] valid ones
LSAP_PADDED = ("padded", 1), ("padded", 2)
PADDED_VALID = (5, 30)
# the cases whose latency bound is logged (lsap_plain run per problem on the host)
LSAP_LATENCY_LOGGED = (LSAP_TIMED, ("n100", 1), *LSAP_PADDED)
# total cost against scipy's, relative: the kernel's duals are f32, scipy's f64
LSAP_TOTAL_TOL = 1e-6
SCIPY_CALLS = [0]  # calls of the host matcher (`train.matcher.assign_scipy`) in this run


def count_scipy_calls(matcher) -> None:
    """Count every call of the host matcher (the costs copied to the host and
    solved by scipy) in SCIPY_CALLS."""
    solve = matcher.assign_scipy

    def counted(cost):
        SCIPY_CALLS[0] += 1
        return solve(cost)

    matcher.assign_scipy = counted


def matcher_counts():
    """(launches of the lsap kernel, calls of the host matcher) so far."""
    from ziragroundingdino_torch.ops.lsap import lsap_cuda

    return lsap_cuda.launches, SCIPY_CALLS[0]


def check_matcher(label: str, before, steps: int) -> int:
    """Each of `steps` train steps since `before` (`matcher_counts()`) matched
    with one launch of the lsap kernel and made no host matcher call (so no
    copy of its costs to the host); returns the launches."""
    lsap, scipy = (now - was for now, was in zip(matcher_counts(), before))
    if (lsap, scipy) != (steps, 0):
        raise AssertionError(f"{label}: {lsap} lsap launches and {scipy} host matcher calls in "
                             f"{steps} train steps, not {steps} and 0")
    return lsap


def lsap_costs(kind: str, b: int, q: int, n: int, seed: int) -> torch.Tensor:
    """Seeded [P, Q, N] f32 costs on the host, P = LSAP_OUTPUTS * b: uniform
    in [0, 10), integers 0..7 (many ties), uniform with the second half of the
    targets' columns at the matcher's BIG, or the lifecycle's padding
    ("padded": problem p is image p % b of its output, as the criterion
    stacks them, with PADDED_VALID[p % b] valid targets, the rest BIG)."""
    rng = np.random.RandomState(seed)
    p = LSAP_OUTPUTS * b
    if kind == "integers":
        cost = rng.randint(0, 8, (p, q, n)).astype(np.float32)
    else:
        cost = (10.0 * rng.rand(p, q, n)).astype(np.float32)
    if kind == "big_columns":
        cost[:, :, n // 2:] = 1.0e7  # train/matcher.py::BIG
    if kind == "padded":
        for k in range(p):
            cost[k, :, PADDED_VALID[k % b]:] = 1.0e7
    return torch.from_numpy(cost)


def scipy_totals(cost: torch.Tensor) -> np.ndarray:
    """Each problem's least total cost, by scipy, summed in float64."""
    from scipy.optimize import linear_sum_assignment

    c = cost.double().numpy()
    return np.array([c[k][linear_sum_assignment(c[k])].sum() for k in range(len(c))])


def host_ms(fn, n: int = 5) -> float:
    """Median host time of `fn` between two synchronisations of the card."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def phase_lsap(lsap_mod, matcher):
    """The lsap kernel against `lsap_plain` at every case of LSAP_CASES:
    assignments exactly equal (the plain version on the host's CPU: the same
    f32 operations give the same values, and it takes seconds there where
    the card's step-by-step syncs take minutes), totals equal to scipy's.
    One launch a call (the wrapper's count; at LSAP_LATENCY_LOGGED also
    torch.profiler: the kernel is the call's only device work wherever it
    records any, and it does for at least one case). Times per
    case: the call (events around it: the wrapper and its launch), the
    device time (a spin first), the host scipy path on the same
    costs (copy to the host, `linear_sum_assignment` per problem, copy
    back), and at the main path's shape the plain version on the card; the
    latency bound (`lsap_latency_bound`) at LSAP_LATENCY_LOGGED. Returns the
    timed case's record for the kernels line, with the padded cases'."""
    record, padded, profiled = None, {}, 0
    for seed, (name, b, q, n, kind) in enumerate(LSAP_CASES):
        p = LSAP_OUTPUTS * b
        cost = lsap_costs(kind, b, q, n, seed)
        dev = cost.cuda()
        before = lsap_mod.lsap_cuda.launches
        got = lsap_mod.lsap_cuda(dev)
        torch.cuda.synchronize()
        if lsap_mod.lsap_cuda.launches != before + 1:
            raise AssertionError(f"lsap at {name} B={b}: not one launch a call")
        t = time.perf_counter()
        want = lsap_mod.lsap_plain(cost)
        plain_cpu_ms = (time.perf_counter() - t) * 1e3
        if not torch.equal(got.cpu(), want):
            bad = (got.cpu() != want).any(1).nonzero().flatten().tolist()
            raise AssertionError(f"lsap disagrees with lsap_plain at {name} B={b}: problems {bad}")
        c64 = cost.double().numpy()
        ours = np.array([c64[k, want[k].numpy(), np.arange(n)].sum() for k in range(p)])
        best = scipy_totals(cost)
        gap = float(np.max(np.abs(ours - best) / np.maximum(1.0, np.abs(best))))
        if not gap <= LSAP_TOTAL_TOL:
            raise AssertionError(f"lsap total cost off scipy's at {name} B={b}: {gap:.3e}")
        ms = time_ms(lambda: lsap_mod.lsap_cuda(dev))
        device_ms = time_ms(lambda: lsap_mod.lsap_cuda(dev), spin=True)
        scipy_ms = host_ms(lambda: matcher.assign_scipy(dev))
        nbytes = p * q * n * 4 + p * n * 8
        # at least one step a target, ~5 operations a column each (the
        # update, the compare): far below the bytes
        ops = p * n * q * 5
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        log(f"lsap {name} B={b} P={p} Q={q} N={n}: assignments equal to lsap_plain, total vs "
            f"scipy rel gap {gap:.2e}; call_ms={ms:.4f} device_ms={device_ms:.4f} "
            f"scipy_host_ms={scipy_ms:.4f} plain_cpu_ms={plain_cpu_ms:.1f} "
            f"bound_ms={bound_ms:.6f} ({bound_by}, {nbytes / 1e6:.3f} MB; latency-bound: "
            f"share {bound_ms / device_ms:.4f}); plan {tuple(lsap_mod.launch_plan(q, n))}")
        rec = dict(max_abs_err=0.0, ms=ms, device_ms=device_ms, plain_cpu_ms=plain_cpu_ms,
                   scipy_host_ms=scipy_ms, bound_ms=bound_ms, bound_by=bound_by)
        if (name, b) in LSAP_LATENCY_LOGGED:
            # the call's device work is the kernel alone: no transpose, no
            # copy. This machine's torch.profiler at times records no device
            # activity for a session: up to 3 tries, and one case must show it.
            for _ in range(3):
                ran = [e.name for e in device_launches(lambda: lsap_mod.lsap_cuda(dev))]
                if ran:
                    break
            if ran and (len(ran) != 1 or "lsap_kernel" not in ran[0]):
                raise AssertionError(f"lsap at {name} B={b}: the call ran {ran} on the device")
            profiled += bool(ran)
            log(f"lsap {name} B={b}: device activities of one call under torch.profiler: "
                f"{ran or 'none recorded'}")
            rec.update(lsap_latency_bound(lsap_mod, cost, n))
            log(f"lsap {name} B={b}: latency bound " + json.dumps(
                {k: rec[k] for k in ("dependent_steps", "row_phases", "sm_clock_mhz",
                                     "latency_bound_ms", "latency_bound_pr8_ms")})
                + f", share {rec['latency_bound_ms'] / device_ms:.4f} of the device time "
                f"({rec['latency_bound_pr8_ms'] / device_ms:.4f} of the PR 8 bound)")
        if (name, b) in LSAP_PADDED:
            padded[f"B={b}"] = {k: v for k, v in rec.items() if k not in ("max_abs_err",
                                                                          "bound_by")}
        if (name, b) == LSAP_TIMED:
            plain_ms = host_ms(lambda: lsap_mod.lsap_plain(dev), n=3)
            if not torch.equal(lsap_mod.lsap_plain(dev).cpu(), want):
                raise AssertionError("lsap_plain on the card disagrees with it on the host")
            log(f"lsap {name} B={b}: lsap_plain on the card {plain_ms:.2f} ms")
            record = dict(rec, plain_ms=plain_ms)
    if not profiled:
        raise AssertionError("lsap: torch.profiler recorded no call's device work")
    record["padded"] = padded
    return record


# Hopper's typical latencies, in SM cycles (a floor: instruction issue,
# shuffles and barrier arrivals are not counted)
STAGE_CYCLES = 600  # the staging's device-memory round trip, paid once
STEP_CYCLES = 20 + 20  # a Dijkstra step on chip: a shared-memory round trip and a barrier
PHASE_CYCLES = 2 * 20  # a row's phases: each a shared round trip and a barrier
STEP_CYCLES_PR8 = 400 + 2 * 20  # PR 8's bound: a row read from L2/HBM each step, two barriers


def lsap_latency_bound(lsap_mod, cost: torch.Tensor, n: int) -> dict:
    """The kernel's least time as a chain of dependent steps: a block solves
    one problem, each Dijkstra step waits for the step before (its row is
    the previous step's argmin). The costs are staged once: one
    device-memory round trip (~600 cycles) and every byte of the launch at
    3.35 TB/s. Then each step costs a shared-memory round trip and a barrier
    (~20 + ~20 cycles: the costs and the column state stay on chip), and
    each of the N rows adds three phases (~40 cycles each, as PR 8 counted
    them). The steps are `lsap_plain`'s count of the longest problem (each
    run alone), at the card's maximum SM clock. The PR 8 bound (every step a
    device-memory round trip and two shared ones, ~440 cycles, no staging)
    is kept beside it, so that earlier shares stay comparable."""
    steps = []
    for k in range(cost.shape[0]):
        before = lsap_mod.lsap_plain.steps
        lsap_mod.lsap_plain(cost[k:k + 1])
        steps.append(lsap_mod.lsap_plain.steps - before)
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    mhz = float(res.stdout.split()[0])
    nbytes = cost.numel() * 4 + cost.shape[0] * n * 8
    cycles = STAGE_CYCLES + max(steps) * STEP_CYCLES + 3 * n * PHASE_CYCLES
    cycles_pr8 = max(steps) * STEP_CYCLES_PR8 + 3 * n * PHASE_CYCLES
    return {"dependent_steps": max(steps), "row_phases": 3 * n, "sm_clock_mhz": mhz,
            "latency_bound_ms": cycles / (mhz * 1e3) + nbytes / HBM_BYTES_PER_S * 1e3,
            "latency_bound_pr8_ms": cycles_pr8 / (mhz * 1e3)}


def tiny_model_kwargs(pc):
    """The tiny Swin/BERT of the repository's tests, 2 + 2 layers, f32."""
    swin = pc.SwinConfig(embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8),
                         window_size=4, drop_path_rate=0.0)
    bert = pc.BertConfig(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                         num_attention_heads=2, intermediate_size=64,
                         max_position_embeddings=64, hidden_dropout=0.0, attention_dropout=0.0)
    return dict(hidden_dim=64, nheads=4, dim_feedforward=128, enc_layers=2, dec_layers=2,
                num_queries=12, max_text_len=32, max_categories=8, swin_config=swin,
                bert_config=bert)


def tiny_models(pc, build_model, tokenizer_mod):
    """The reduced-depth f32 model on the CPU and on the card with the same
    weights, and its inputs: 2 images (one padded) and 2 captions."""
    kw = tiny_model_kwargs(pc)
    cpu = build_model(device="cpu", dtype="float32", seed=1, **kw)
    # seeded noise on every tensor, so zero-initialized parts (box-head last
    # layers, ZiRa freeze branches) take part in the comparison
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for p in cpu.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    card = build_model(device="cuda", dtype="float32", seed=1, **kw)
    card.load_state_dict(cpu.state_dict(), strict=True)

    tok = tokenizer_mod.WordPieceTokenizer(tokenizer_mod.make_synthetic_vocab(
        ["cat", "dog", "zebra", "person", "fish", "car"]))
    tb = tokenizer_mod.tokenize_captions(tok, ["cat.dog.", "zebra.person.fish."],
                                         max_text_len=32, max_categories=8,
                                         text_len_buckets=(16, 32))
    rng = np.random.RandomState(0)
    pixels = rng.randn(2, 64, 96, 3).astype(np.float32)
    mask = np.zeros((2, 64, 96), bool)
    mask[0] = True
    mask[1, :51, :76] = True
    return cpu, card, tb, pixels, mask


def phase_model_card_vs_cpu(models):
    cpu, card, tb, pixels, mask = models
    outs = []
    for model, dev in ((cpu, "cpu"), (card, "cuda")):
        text = {k: torch.from_numpy(v).to(dev) for k, v in tb.asdict().items()}
        with torch.inference_mode():
            outs.append(model(torch.from_numpy(pixels).to(dev), torch.from_numpy(mask).to(dev),
                              text))
    ref, got = outs
    same_idx = torch.equal(ref["topk_idx"], got["topk_idx"].cpu())
    errs = {k: (got[k].cpu() - ref[k]).abs().max().item() for k in ("pred_logits", "pred_boxes")}
    log(f"model card vs cpu (tiny f32, 2+2 layers): topk equal={same_idx} "
        f"pred_logits max_abs_err={errs['pred_logits']:.3e} "
        f"pred_boxes max_abs_err={errs['pred_boxes']:.3e} tol={MODEL_TOL}")
    if not same_idx:
        raise AssertionError("top-k query indices differ between the card and the CPU")
    for k, e in errs.items():
        if not e <= MODEL_TOL:
            raise AssertionError(f"{k} differs between the card and the CPU: {e}")


def train_batch(tb, pixels, mask, device, n_boxes=5, n_labels=2, seed=7):
    """A train batch: the images and captions with `n_boxes` seeded target
    boxes (cxcywh) per image, labels below `n_labels`, all valid."""
    rng = np.random.RandomState(seed)
    b = pixels.shape[0]
    centers = rng.uniform(0.2, 0.8, (b, n_boxes, 2))
    sizes = rng.uniform(0.05, 0.3, (b, n_boxes, 2))
    batch = dict(tb.asdict(), pixels=pixels, mask=mask,
                 cate_to_token_mask=tb.cate_to_token_mask,
                 gt_boxes=np.concatenate([centers, sizes], -1).astype(np.float32),
                 gt_labels=rng.randint(0, n_labels, (b, n_boxes)).astype(np.int64),
                 gt_valid=np.ones((b, n_boxes), bool))
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}


def phase_train_card_vs_cpu(models, criterion, optim, step, msda_forward, msda_backward):
    """The tiny model's loss and trainable gradients, card vs CPU. The card
    replays the CPU matcher's assignments, so that a near-tie cannot pick
    other targets. Each trainable gradient is held at MODEL_TOL of its own
    largest magnitude."""
    cpu, card, tb, pixels, mask = models
    match_batch = criterion.match_batch
    assignments = []

    def record(*args, **kwargs):
        assignments.append(match_batch(*args, **kwargs))
        return assignments[-1]

    results = []
    try:
        for model, dev in ((cpu, "cpu"), (card, "cuda")):
            optim.set_trainable(model, optim.ZIRA_TRAINABLE_PATTERNS)
            if dev == "cpu":
                criterion.match_batch = record
            else:
                replay = iter(assignments)
                criterion.match_batch = lambda *args, **kwargs: next(replay).to(dev)
            fwd, bwd = msda_forward.launches, msda_backward.launches
            total, losses = step.compute_losses(model, train_batch(tb, pixels, mask, dev))
            total.backward()
            launched = (msda_forward.launches - fwd, msda_backward.launches - bwd)
            grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()
                     if p.requires_grad}
            results.append(({k: v.item() for k, v in losses.items()}, grads, launched))
    finally:
        criterion.match_batch = match_batch
    (ref_losses, ref_grads, _), (losses, grads, launched) = results
    n_layers = card.cfg.enc_layers + card.cfg.dec_layers
    if launched != (n_layers, n_layers):
        raise AssertionError(f"tiny train step on the card launched (forward, backward) "
                             f"{launched}, not {n_layers} each")
    loss_err = max(abs(losses[k] - v) / max(abs(v), 1e-30) for k, v in ref_losses.items())
    # each tensor's largest |difference| over its own largest |gradient|
    grad_err = {n: (grads[n] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
                for n, g in ref_grads.items()}
    worst = max(grad_err, key=grad_err.get)
    log(f"train step card vs cpu (tiny f32, 2+2 layers, {len(grads)} trainable tensors): "
        f"losses max rel err {loss_err:.3e}, gradients max rel err {grad_err[worst]:.3e} "
        f"({worst}), tol {MODEL_TOL} of each tensor's scale; "
        f"msda launches (forward, backward) {launched}")
    log("  gradient rel err per tensor: " + ", ".join(
        f"{n} {e:.2e}" for n, e in sorted(grad_err.items(), key=lambda kv: -kv[1])))
    if not loss_err <= MODEL_TOL:
        raise AssertionError(f"train losses differ between the card and the CPU: {loss_err}")
    if not grad_err[worst] <= MODEL_TOL:
        raise AssertionError(f"trainable gradient {worst} differs between the card and the CPU: "
                             f"{grad_err[worst]:.3e} of its scale")


def synthetic_u8() -> np.ndarray:
    """The seeded 800x1199 uint8 image of the main path."""
    return np.random.RandomState(0).randint(0, 256, (800, 1199, 3)).astype(np.uint8)


def synthetic_image(transforms, pc):
    """`synthetic_u8`, normalized and padded to its bucket (800x1216):
    pixels [1, H, W, 3], mask [1, H, W]."""
    image = synthetic_u8()
    data_cfg = pc.DataConfig()
    bucket = transforms.pick_bucket(800, 1199, data_cfg.shape_buckets)
    pixels, mask = transforms.pad_to_bucket(transforms.normalize(image, data_cfg), bucket)
    return pixels[None], mask[None]


REQUEST_WORDS = ["person", "dog", "cat", "car", "bicycle", "traffic", "light", "zebra", "fish",
                 "boat", "bird", "horse", "umbrella", "kite", "bottle", "cup", "the", "a",
                 "left", "red", "on", "of", "man", "riding"]
REQUEST_CAPTIONS = ["person . dog . cat .", "a man riding a bicycle", "red traffic light . car",
                    "zebra . horse . bird . kite . umbrella"]


def phase_main_path(build_model, inference, tokenizer_mod, transforms, pc, msda_forward,
                    msda_backward, card_line):
    t0 = time.time()
    model = build_model("dualzerorepbranchgroundingdino", device="cuda", dtype="bfloat16",
                        seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"main path: built dualzerorepbranchgroundingdino ({n_params / 1e6:.1f} M params, "
        f"bf16 compute) in {time.time() - t0:.1f} s")
    lm = inference.LoadedModel(model=model, tokenizer=tokenizer_mod.WordPieceTokenizer(
        tokenizer_mod.make_synthetic_vocab(REQUEST_WORDS)))
    cfg = model.cfg
    pixels, mask = synthetic_image(transforms, pc)
    captions = REQUEST_CAPTIONS

    from ziragroundingdino_torch.ops.fusion_attn import fusion_attention

    captured = {}
    hook = model.register_forward_hook(lambda m, a, out: captured.__setitem__("out", out))
    msda_forward.launches = msda_backward.launches = 0
    request_ms = []
    torch.cuda.reset_peak_memory_stats()
    try:
        for i, caption in enumerate(captions):
            before = msda_forward.launches
            fused_before = fusion_attention.launches
            torch.cuda.synchronize()
            t = time.perf_counter()
            boxes, scores, phrases = inference.predict(lm, pixels, mask, caption)
            torch.cuda.synchronize()
            request_ms.append((time.perf_counter() - t) * 1e3)
            out = captured.pop("out")
            launched = msda_forward.launches - before
            fused = fusion_attention.launches - fused_before
            logits, pboxes = out["pred_logits"], out["pred_boxes"]
            log(f"request {i}: {caption!r}: {request_ms[-1]:.1f} ms, {len(boxes)} boxes kept, "
                f"msda_forward launches {launched}, fusion_attention launches {fused}, "
                f"phrases {phrases[:3]}")
            if tuple(logits.shape) != (1, cfg.num_queries, cfg.max_text_len):
                raise AssertionError(f"pred_logits shape {tuple(logits.shape)}")
            if tuple(pboxes.shape) != (1, cfg.num_queries, 4):
                raise AssertionError(f"pred_boxes shape {tuple(pboxes.shape)}")
            if not (torch.isfinite(logits).all() and torch.isfinite(pboxes).all()):
                raise AssertionError("non-finite detections")
            if not ((pboxes >= 0) & (pboxes <= 1)).all():
                raise AssertionError("boxes outside [0, 1]")
            if launched != cfg.enc_layers + cfg.dec_layers:
                raise AssertionError(f"msda_forward launched {launched} times in one request")
            if fused != cfg.enc_layers:
                raise AssertionError(f"fusion_attention launched {fused} times in one request")
    finally:
        hook.remove()
    launches = msda_forward.launches
    if msda_backward.launches:
        raise AssertionError(f"serving launched msda_backward {msda_backward.launches} times")
    peak = torch.cuda.max_memory_allocated()
    log(f"main path: {len(captions)} requests at 800x1216, per-request ms "
        f"{[round(x, 2) for x in request_ms]} (first includes warm-up), "
        f"steady median {statistics.median(request_ms[1:]):.2f} ms, "
        f"peak memory {peak / 2**30:.2f} GiB, on {card_line}")
    return launches, (model, lm, pixels, mask, captions)


def record_gradients(opt):
    """Wraps `opt.step` so that each step first records, per trainable
    tensor, the largest |gradient| the backward left on it (0 where it left
    none), before `Optimizer.step` gives a tensor without one a zero
    gradient that AdamW's weight decay then moves it by. Returns a function
    that ends the recording (so that no reference cycle keeps `opt` and its
    state alive) and gives the names whose gradient was all zero, or
    absent, in every step."""
    names = list(opt.params)
    peak = torch.zeros(len(names), device="cuda")
    step = opt.step

    def recording():
        idx = [i for i, n in enumerate(names) if opt.params[n].grad is not None]
        if idx:
            norms = torch._foreach_norm([opt.params[names[i]].grad for i in idx], float("inf"))
            at = torch.tensor(idx, device=peak.device)
            peak[at] = torch.maximum(peak[at], torch.stack(norms).float())
        return step()

    def ungraded():
        del opt.step
        return [n for n, v in zip(names, peak.tolist()) if not v > 0]

    opt.step = recording
    return ungraded


def phase_train_main_path(build_model, optim, step, tokenizer_mod, transforms, pc, msda_forward,
                          msda_backward, card_line, profile_dir=None):
    """TRAIN_STEPS train steps of the full-width preset on one synthetic
    800x1216 image, a 4-category caption and 5 seeded boxes, with dropout
    at the preset's rates from a CUDA generator. Returns the launches of
    both kernels over the steps, and the binned ones of the backward (its
    encoder calls)."""
    t0 = time.time()
    model = build_model("dualzerorepbranchgroundingdino", device="cuda", dtype="bfloat16",
                        seed=0)
    optim.set_trainable(model, optim.ZIRA_TRAINABLE_PATTERNS)
    opt = optim.Optimizer(model, pc.OptimizerConfig(), pc.ScheduleConfig())
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if not p.requires_grad}
    start = {n: p.detach().clone() for n, p in opt.params.items()}
    ungraded = record_gradients(opt)
    n_train = sum(p.numel() for p in opt.params.values())
    log(f"train path: built the preset in {time.time() - t0:.1f} s; "
        f"{len(opt.params)} trainable tensors ({n_train / 1e6:.2f} M parameters), "
        f"{len(frozen)} frozen")
    cfg = model.cfg
    words = ["person", "dog", "cat", "car"]
    tok = tokenizer_mod.WordPieceTokenizer(tokenizer_mod.make_synthetic_vocab(words))
    tb = tokenizer_mod.tokenize_captions(tok, [" . ".join(words) + " ."],
                                         max_text_len=cfg.max_text_len,
                                         max_categories=cfg.max_categories)
    pixels, mask = synthetic_image(transforms, pc)
    batch = train_batch(tb, pixels, mask, "cuda", n_labels=len(words))
    gen = torch.Generator(device="cuda").manual_seed(0)
    n_layers = cfg.enc_layers + cfg.dec_layers

    step_ms = []
    torch.cuda.reset_peak_memory_stats()
    msda_forward.launches = msda_backward.launches = msda_backward.binned_launches = 0
    matched = matcher_counts()
    for i in range(TRAIN_STEPS):
        fwd, bwd, binned = (msda_forward.launches, msda_backward.launches,
                            msda_backward.binned_launches)
        before = matcher_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = step.train_step(model, opt, batch, gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        launched = (msda_forward.launches - fwd, msda_backward.launches - bwd)
        n_binned = msda_backward.binned_launches - binned
        check_matcher(f"train step {i}", before, 1)
        loss = metrics["total_loss"].item()
        log(f"train step {i}: {step_ms[-1]:.1f} ms, total_loss {loss:.4f}, grad_norm "
            f"{metrics['grad_norm'].item():.4f}, msda launches (forward, backward) {launched}, "
            f"{n_binned} of the backward binned, 1 lsap launch")
        if not np.isfinite(loss):
            raise AssertionError(f"train step {i}: loss {loss}")
        if launched != (n_layers, n_layers):
            raise AssertionError(f"train step {i} launched (forward, backward) {launched}, "
                                 f"not {n_layers} each")
        if n_binned != cfg.enc_layers:
            raise AssertionError(f"train step {i}: {n_binned} binned backward calls, not one "
                                 f"per encoder layer ({cfg.enc_layers})")
    launches = (msda_forward.launches, msda_backward.launches, msda_backward.binned_launches,
                check_matcher("train path", matched, TRAIN_STEPS))
    peak = torch.cuda.max_memory_allocated()
    moved = [n for n, p in opt.params.items() if not torch.equal(p.detach(), start[n])]
    changed = [n for n, p in model.named_parameters()
               if not p.requires_grad and not torch.equal(p.detach(), frozen[n])]
    no_grad = ungraded()
    log(f"train path: {TRAIN_STEPS} steps at 800x1216, bf16, per-step ms "
        f"{[round(x, 2) for x in step_ms]} (first includes warm-up), warm median "
        f"{statistics.median(step_ms[1:]):.2f} ms, peak memory {peak / 2**30:.2f} GiB; "
        f"{len(opt.params) - len(no_grad)} of {len(opt.params)} trainable tensors given a "
        f"gradient, {len(moved)} moved, {len(changed)} frozen changed; on {card_line}")
    if changed:
        raise AssertionError(f"frozen parameters changed: {changed[:5]}")
    if no_grad:
        raise AssertionError(f"the backward gave no gradient to trainable {no_grad}")
    if len(moved) != len(opt.params):
        raise AssertionError(f"trainable parameters did not move: "
                             f"{sorted(set(opt.params) - set(moved))[:5]}")
    matcher = compare_matchers(model, opt, step, batch, gen, card_line)
    if profile_dir is not None:
        profile_window("train step", lambda: step.train_step(model, opt, batch, gen), 2,
                       profile_dir / "train_trace.json.gz", card_line)
    return launches, statistics.median(step_ms[1:]), peak, matcher


MATCHER_ORDER = ("scipy", "lsap", "lsap", "scipy")  # phase 5b's warm steps, in turns


def sync_calls(fn) -> int:
    """Synchronising CUDA calls made by `fn`, counted as the warnings of
    `torch.cuda.set_sync_debug_mode("warn")`."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def compare_matchers(model, opt, step, batch, gen, card_line) -> dict:
    """Warm train steps with each matcher in the same run (MATCHER_ORDER),
    then one step each under the sync debug mode: the host path copies the
    costs to the host (one sync a step, all 7 outputs at once), the kernel
    makes none. Returns the step ms and the syncs of each."""
    step_ms = {impl: [] for impl in MATCHER_ORDER}
    for impl in MATCHER_ORDER:
        before = matcher_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        step.train_step(model, opt, batch, gen, matcher_impl=impl)
        torch.cuda.synchronize()
        step_ms[impl].append((time.perf_counter() - t) * 1e3)
        lsap, scipy = (now - was for now, was in zip(matcher_counts(), before))
        if (lsap, scipy) != ((1, 0) if impl == "lsap" else (0, 1)):
            raise AssertionError(f"a step with matcher_impl={impl!r}: {lsap} lsap launches, "
                                 f"{scipy} host matcher calls")
    syncs = {impl: sync_calls(lambda: step.train_step(model, opt, batch, gen,
                                                      matcher_impl=impl))
             for impl in ("scipy", "lsap")}
    log(f"train path, matcher both ways in turns {MATCHER_ORDER}: step ms "
        + ", ".join(f"{k} {[round(x, 2) for x in v]}" for k, v in step_ms.items())
        + f"; synchronising calls per step {syncs}; on {card_line}")
    if not syncs["lsap"] < syncs["scipy"]:
        raise AssertionError(f"the lsap step synchronised as often as the host matcher's: "
                             f"{syncs}")
    return {"step_ms": step_ms, "sync_calls_per_step": syncs}


# ---------------------------------------------------------------------------
# 6. the ZiRa lifecycle at full width
# ---------------------------------------------------------------------------

LIFECYCLE_TASKS = {  # ODinW task name: (classes, train images, test images)
    "CottontailRabbits": (["person", "dog", "cat"], 6, 3),
    "pothole": (["car", "bicycle"], 4, 3),
}
LIFECYCLE_ORIG = (600, 800)  # synthetic originals (h, w): eval at 800x1066 in 800x1216
LIFECYCLE_ITERS, LIFECYCLE_CKPT, LIFECYCLE_REPLAY, LIFECYCLE_BATCH = 4, 2, 2, 2
LIFECYCLE_MEMORY = {"-fish-": 2, "-boat-": 1}  # the checkpoint's prompt memory: name, tokens
MERGE_TOL = 1e-6  # freeze + scaling * branch in f32, times max(1, |freeze|)
# before the merge (train mode, freeze + scaling * branch, two bf16 matmuls)
# against after it (eval, one bf16 matmul of the merged f32 weight): the
# relative Frobenius error of the encoder's image and text memory and of the
# encoded text, bf16 rounding of the weights carried through 6 layers
MERGE_BF16_TOL = 2e-2
MERGE_EFFECT = 5.0  # the branches' own effect must exceed the error this many times


def _seeded_rep_modules(model, seed: int = 3):
    """Every ZiRa freeze and branch weight of `model` drawn from N(0, 1 /
    fan_in), biases from N(0, 0.01): a checkpoint whose branches matter, so
    that the merge check has something to see. The multilayer variant's
    `freeze_gn` and ZeroConvBN's BatchNorm get scales of 1 + N(0, 0.01),
    biases and means of N(0, 0.01) and variances in [0.5, 1.5]."""
    from ziragroundingdino_torch.models.zira import (
        RepZeroConv,
        RepZeroConvGN,
        RepZeroLinear,
        RepZeroLoRA,
        ZeroConvBN,
    )

    g = torch.Generator().manual_seed(seed)

    def weights(*ws):
        for w in ws:
            w.copy_(torch.randn(w.shape, generator=g) / w[0].numel() ** 0.5)

    def small(*ts):
        for t in ts:
            t.copy_(0.01 * torch.randn(t.shape, generator=g))

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (RepZeroLinear, RepZeroConv)):
                freeze = mod.freeze_linear if isinstance(mod, RepZeroLinear) else mod.freeze_conv
                for w, b in ((mod.weight, mod.bias), (freeze.weight, freeze.bias)):
                    weights(w)
                    small(b)
                if isinstance(mod, RepZeroConvGN):
                    mod.freeze_gn.weight.copy_(1 + 0.01 * torch.randn(
                        mod.freeze_gn.weight.shape, generator=g))
                    small(mod.freeze_gn.bias)
            elif isinstance(mod, RepZeroLoRA):
                weights(mod.down.weight, mod.up.weight, mod.freeze_linear.weight)
            elif isinstance(mod, ZeroConvBN):
                conv, bn = mod.branch.conv, mod.branch.bn
                weights(conv.weight, mod.freeze_conv.weight)
                small(conv.bias, mod.freeze_conv.bias, bn.bias, bn.running_mean)
                bn.weight.copy_(1 + 0.01 * torch.randn(bn.weight.shape, generator=g))
                bn.running_var.copy_(0.5 + torch.rand(bn.running_var.shape, generator=g))


class _Instruments:
    """Timed, counting wrappers around the lifecycle's stages, installed on
    the modules whose globals the driver reads and removed by `restore`."""

    def __init__(self, modules):
        self.modules = modules
        self.saved = []
        self.times = {k: [] for k in ("load", "step", "checkpoint", "merge", "prompt",
                                      "state_save", "replay", "eval_batch")}
        self.plain_calls = 0

    def _timed(self, name, fn):
        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.times[name].append((time.perf_counter() - t) * 1e3)
            return out
        return wrapper

    def _patch(self, module, name, new):
        self.saved.append((module, name, getattr(module, name)))
        setattr(module, name, new)

    def install(self):
        m = self.modules
        for module, name, key in (
                ("inference", "load_model", "load"), ("trainer", "train_step", "step"),
                ("trainer", "save_checkpoint", "checkpoint"), ("incremental", "rep_merge", "merge"),
                ("incremental", "add_cls_prompt", "prompt"),
                ("incremental", "save_incremental_state", "state_save"),
                ("incremental", "run_replay_phase", "replay")):
            self._patch(m[module], name, self._timed(key, getattr(m[module], name)))
        make_fn = m["evaluator"].make_inference_fn
        self._patch(m["evaluator"], "make_inference_fn",
                    lambda *a, **k: self._timed("eval_batch", make_fn(*a, **k)))
        for name in ("ms_deform_attn_plain", "ms_deform_attn_backward_plain"):
            plain = getattr(m["msda"], name)

            def counted(*a, _plain=plain, **k):
                self.plain_calls += 1
                return _plain(*a, **k)
            self._patch(m["msda"], name, counted)

    def restore(self):
        for module, name, old in reversed(self.saved):
            setattr(module, name, old)
        self.saved = []


def _rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _merge_on_a_batch(build_model, root, out, tokenizer, cfg, dcfg):
    """A fixed eval batch of task A through the model before its merge
    (`ckpt/step_N.pt`: deterministic train mode, and eval mode, which sees
    the freeze branches only) and after it (`state_final.pt`, eval mode):
    the encoder's image and text memory and the encoded text. Returns
    {what: (error after vs before, the branches' effect)}."""
    from ziragroundingdino_torch.data.coco import CocoDataset
    from ziragroundingdino_torch.data.loader import DataLoader
    from ziragroundingdino_torch.models.groundingdino import TextEncoderOnly

    name = next(iter(LIFECYCLE_TASKS))
    task_dir = out / name
    base = root / "data" / name
    ds = CocoDataset.from_json(str(base / "test" / "annotations_without_background.json"),
                               str(base / "test"))
    batch = next(iter(DataLoader(ds, tokenizer, dcfg, batch_size=LIFECYCLE_BATCH, train=False,
                                 max_text_len=cfg.max_text_len,
                                 max_categories=cfg.max_categories)))
    b = {k: torch.from_numpy(np.asarray(batch[k])).cuda() for k in (
        "pixels", "mask", "input_ids", "text_token_mask", "position_ids",
        "text_self_attention_masks")}
    text = {k: b[k] for k in ("input_ids", "text_token_mask", "position_ids",
                              "text_self_attention_masks")}
    model = build_model("dualzerorepbranchgroundingdino", device="cuda", dtype="bfloat16")

    def run(train):
        got = {}
        hook = model.transformer.encoder.register_forward_hook(
            lambda m, a, o: got.update(image=o[0], text=o[1]))
        try:
            with torch.no_grad():
                model(b["pixels"], b["mask"], text, train=train)
                got["encoded_text"] = TextEncoderOnly(model)(text, train=train)[0]
        finally:
            hook.remove()
        return got

    ckpt = torch.load(task_dir / "ckpt" / f"step_{LIFECYCLE_ITERS}.pt", map_location="cuda",
                      weights_only=True)
    model.load_state_dict(ckpt["model"])
    before, unmerged = run(True), run(False)
    model.load_state_dict(torch.load(task_dir / "state_final.pt", map_location="cuda",
                                     weights_only=True)["params"])
    after = run(False)
    del model
    return {k: (_rel_err(after[k], before[k]), _rel_err(unmerged[k], before[k])) for k in before}


def check_zira_merge(label: str, before: dict, trained: dict, merged: dict, cfg) -> float:
    """Holds a merge of the ZiRa preset (`rep_merge`: `trained` -> `merged`,
    state dicts): every non-ZiRa tensor as in `before`, bitwise; each freeze
    tensor the trained freeze + scaling * branch within MERGE_TOL of its
    scale; the branches and the scalings reset to the config's inits.
    Returns the largest relative error of a freeze tensor."""
    from ziragroundingdino_torch.models.zira import ZERO_VALUE

    changed = [k for k, v in merged.items() if "adapter" not in k and not torch.equal(v, before[k])]
    if changed:
        raise AssertionError(f"{label} changed non-ZiRa tensors: {changed[:5]}")
    merge_err = 0.0
    for mod in ["rep_linear_adapter"] + [f"input_proj_conv_adapter.{i}" for i in range(4)]:
        freeze = "freeze_linear" if mod == "rep_linear_adapter" else "freeze_conv"
        s = trained[f"{mod}.scaling"]
        for part in ("weight", "bias"):
            want_f = trained[f"{mod}.{freeze}.{part}"] + s * trained[f"{mod}.{part}"]
            err = float((merged[f"{mod}.{freeze}.{part}"] - want_f).abs().max()
                        / max(1.0, float(want_f.abs().max())))
            merge_err = max(merge_err, err)
            if err > MERGE_TOL:
                raise AssertionError(f"{label}: {mod}.{freeze}.{part} off by {err}")
            if not torch.all(merged[f"{mod}.{part}"] == ZERO_VALUE):
                raise AssertionError(f"{label}: {mod}.{part} not reset")
        reset = cfg.zira_lan_scale if mod == "rep_linear_adapter" else cfg.zira_vis_scale
        if not torch.all(merged[f"{mod}.scaling"] == reset):
            raise AssertionError(f"{label}: {mod}.scaling not reset")
    return merge_err


def write_lifecycle_inputs(build_model, root: pathlib.Path):
    """Phase 6's inputs under `root` (made anew): the seeded reference-format
    checkpoint of the ZiRa preset with seeded branches and a prompt memory,
    a vocab, the two synthetic ODinW tasks and the overrides. Returns (the
    checkpoint's state dict, its prompt memory, the vocab)."""
    from ziragroundingdino_torch.data import synthetic
    from ziragroundingdino_torch.text.tokenizer import make_synthetic_vocab

    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    model = build_model("dualzerorepbranchgroundingdino", device="cpu", dtype="bfloat16", seed=0)
    _seeded_rep_modules(model)
    g = torch.Generator().manual_seed(4)
    memory = {k: torch.randn(n, model.cfg.hidden_dim, generator=g)
              for k, n in LIFECYCLE_MEMORY.items()}
    sd = dict(model.state_dict())
    sd.update({f"prompt_memory_pool.{k}": v for k, v in memory.items()})
    torch.save({"model": sd}, root / "ckpt.pth")
    before_all = {k: v.clone() for k, v in model.state_dict().items()}
    del model, sd
    words = [c for classes, _, _ in LIFECYCLE_TASKS.values() for c in classes] + ["fish", "boat"]
    vocab = make_synthetic_vocab(words)
    synthetic.write_vocab(str(root / "vocab.txt"), vocab)
    for i, (name, (classes, n_train, n_test)) in enumerate(LIFECYCLE_TASKS.items()):
        synthetic.write_odinw_task(str(root / "data"), name, classes, n_train, n_test,
                                   LIFECYCLE_ORIG, seed=100 + 10 * i)
    (root / "overrides.json").write_text(json.dumps(
        {"model": {"use_add_names": True, "use_learned_names": True}}))
    return before_all, memory, vocab


def lifecycle_args(root: pathlib.Path, out: pathlib.Path, iters: int, ckpt: int,
                   replay: int) -> list:
    """`train_odinw`'s arguments for phase 6's inputs under `root`."""
    return ["--checkpoint", str(root / "ckpt.pth"), "--vocab", str(root / "vocab.txt"),
            "--datasets-root", str(root / "data"), "--tasks", ",".join(LIFECYCLE_TASKS),
            "--output-dir", str(out), "--batch-size", str(LIFECYCLE_BATCH),
            "--max-iter", str(iters), "--checkpoint-period", str(ckpt),
            "--replay-iters", str(replay), "--config-overrides", str(root / "overrides.json")]


def phase_lifecycle(build_model, msda_forward, msda_backward, card_line):
    """The ZiRa lifecycle at full width through the port's ODinW script
    (`scripts/train_odinw.main`): a seeded reference-format checkpoint with
    a prompt memory, two synthetic ODinW tasks (600x800 PPM originals, eval
    at 800x1066 in 800x1216, training at `train_short_sides`), learned-name
    caption augmentation on, LIFECYCLE_ITERS iterations a task at batch
    LIFECYCLE_BATCH with a checkpoint every LIFECYCLE_CKPT, the merge, the
    prompt capture, LIFECYCLE_REPLAY replay iterations and the eval of both
    tasks. Then the checks (launches, the merges, the report) and a second
    run that must restore both tasks and report the same. Returns the two
    kernels' launches over the first run."""
    from ziragroundingdino_torch import config as pc
    from ziragroundingdino_torch.eval import evaluator
    from ziragroundingdino_torch.ops import msda
    from ziragroundingdino_torch.scripts import train_odinw
    from ziragroundingdino_torch.text.tokenizer import WordPieceTokenizer
    from ziragroundingdino_torch.train import incremental
    from ziragroundingdino_torch.train import trainer as trainer_mod
    from ziragroundingdino_torch.utils import inference

    root = pathlib.Path(__file__).resolve().parent / "build" / "lifecycle"
    t0 = time.time()
    before_all, memory, vocab = write_lifecycle_inputs(build_model, root)
    out = root / "out"
    args = lifecycle_args(root, out, LIFECYCLE_ITERS, LIFECYCLE_CKPT, LIFECYCLE_REPLAY)
    log(f"lifecycle: checkpoint, vocab and {len(LIFECYCLE_TASKS)} tasks written in "
        f"{time.time() - t0:.1f} s")

    inst = _Instruments({"inference": inference, "trainer": trainer_mod,
                         "incremental": incremental, "evaluator": evaluator, "msda": msda})
    inst.install()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        msda_forward.launches = msda_backward.launches = msda_backward.binned_launches = 0
        matched = matcher_counts()
        t = time.perf_counter()
        report = train_odinw.main(args)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        launches = (msda_forward.launches, msda_backward.launches,
                    msda_backward.binned_launches)
        matcher_run = [now - was for now, was in zip(matcher_counts(), matched)]
        peak = torch.cuda.max_memory_allocated()
        times = {k: list(v) for k, v in inst.times.items()}
        plain_calls = inst.plain_calls

        # the second run: both tasks restored from state_final, no training
        for v in inst.times.values():
            v.clear()
        t = time.perf_counter()
        report2 = train_odinw.main(args)
        rerun_s = time.perf_counter() - t
        rerun_steps = len(inst.times["step"])
    finally:
        inst.restore()

    n_layers, n_enc = 12, 6  # the preset's 6 encoder + 6 decoder layers
    steps, batches = len(times["step"]), len(times["eval_batch"])
    want_steps = LIFECYCLE_ITERS * len(LIFECYCLE_TASKS)
    want_batches = sum(-(-n_test // LIFECYCLE_BATCH) for _, _, n_test in LIFECYCLE_TASKS.values())
    log(f"lifecycle: run 1 in {run_s:.1f} s: {steps} train steps, {batches} eval batches, "
        f"msda launches (forward, backward, binned) {launches}; report {report}")
    if (steps, batches) != (want_steps, want_batches):
        raise AssertionError(f"{steps} steps and {batches} eval batches, "
                             f"not {want_steps} and {want_batches}")
    # `train_odinw` trains with remat: each step recomputes the encoder's 6
    want = (n_layers * (steps + batches) + n_enc * steps, n_layers * steps, n_enc * steps)
    if launches != want:
        raise AssertionError(f"lifecycle msda launches {launches}, not {want}")
    if plain_calls:
        raise AssertionError(f"the lifecycle called the plain MSDA {plain_calls} times")
    if matcher_run != [steps, 0]:
        raise AssertionError(f"lifecycle: (lsap launches, host matcher calls) {matcher_run} in "
                             f"{steps} train steps, not ({steps}, 0)")

    # the merges: only the ZiRa modules change; freeze = trained freeze +
    # scaling * trained branch; branch and scaling reset
    cfg = pc.get_model_config("dualzerorepbranchgroundingdino")
    before = before_all
    merge_err = 0.0
    for name in LIFECYCLE_TASKS:
        final = torch.load(out / name / "state_final.pt", map_location="cpu", weights_only=True)
        trained = torch.load(out / name / "ckpt" / f"step_{LIFECYCLE_ITERS}.pt",
                             map_location="cpu", weights_only=True)["model"]
        params = final["params"]
        merge_err = max(merge_err, check_zira_merge(f"task {name}", before, trained, params, cfg))
        for k, v in memory.items():
            if not torch.equal(final["prompt_memory"][k], v):
                raise AssertionError(f"task {name}: the checkpoint's prompt {k} left the chain")
        missing = {f"-{c}-" for c in LIFECYCLE_TASKS[name][0]} - set(final["prompt_memory"])
        if missing:
            raise AssertionError(f"task {name}: no prompt for {missing}")
        before = params
    learned = json.loads((out / name / "state_final.pt.classes.json").read_text())
    if learned != [c for classes, _, _ in LIFECYCLE_TASKS.values() for c in classes]:
        raise AssertionError(f"learned classes {learned}")

    tokenizer = WordPieceTokenizer(vocab)
    merged = _merge_on_a_batch(build_model, root, out, tokenizer, cfg, pc.DataConfig())
    log("lifecycle: task A's merge on an eval batch, relative error after vs before "
        "(and the branches' own effect): " + ", ".join(
            f"{k} {e:.2e} ({x:.2e})" for k, (e, x) in merged.items()))
    for k, (err, effect) in merged.items():
        if err > MERGE_BF16_TOL or effect < MERGE_EFFECT * err:
            raise AssertionError(f"merge on an eval batch, {k}: error {err}, effect {effect}")

    keys = {f"AP/{n}" for n in LIFECYCLE_TASKS} | {"avg_AP"}
    if set(report) != keys or not all(np.isfinite(v) for v in report.values()):
        raise AssertionError(f"report {report}")
    saved = json.loads((out / "result.json").read_text())
    if report2 != report or saved != report or rerun_steps:
        raise AssertionError(f"rerun: {report2} ({rerun_steps} steps) against {report}")
    log(f"lifecycle: run 2 restored both tasks from state_final and reported the same in "
        f"{rerun_s:.1f} s")

    per_task = [times["step"][i * LIFECYCLE_ITERS:(i + 1) * LIFECYCLE_ITERS]
                for i in range(len(LIFECYCLE_TASKS))]
    eval_ms = statistics.median(times["eval_batch"][1:])
    numbers = {
        "card": card_line,
        "at": f"dualzerorepbranchgroundingdino, bf16, batch {LIFECYCLE_BATCH}, "
              f"{len(LIFECYCLE_TASKS)} tasks x {LIFECYCLE_ITERS} steps, 600x800 originals",
        "step_ms_per_task": per_task,
        "warm_step_median_ms_per_task": [statistics.median(t[1:]) for t in per_task],
        "load_model_ms": times["load"],
        "checkpoint_save_ms": times["checkpoint"],
        "state_save_ms": times["state_save"],
        "merge_ms": times["merge"],
        "prompt_capture_ms": times["prompt"],
        "eval_ms_per_batch": times["eval_batch"],
        "eval_sec_per_img": eval_ms / LIFECYCLE_BATCH / 1e3,
        "replay_ms_per_iter": times["replay"][0] / LIFECYCLE_REPLAY,
        "run_s": run_s, "rerun_s": rerun_s,
        "peak_memory_gib": peak / 2**30,
        "merge_f32_max_rel_err": merge_err,
        "report": report,
    }
    log("lifecycle: " + json.dumps(numbers))
    shutil.rmtree(root, ignore_errors=True)
    return launches + (matcher_run[0],)


# ---------------------------------------------------------------------------
# 7. the released model served, and the rest of the ZiRa family trained
# ---------------------------------------------------------------------------

# (label, preset, overrides) of phase 7c
FAMILY = [("repgroundingdino", "repgroundingdino", {}),
          ("multilayer", "dualzerorepmultilayerbranchgroundingdino", {}),
          ("repconvbn", "repconvbngroundingdino", {}),
          ("lora", "dualzerorepbranchgroundingdino", {"zira_lan_adapter": "lora"})]
FAMILY_STEPS = 2
VANILLA_TOL = 1e-3  # ZiRa-from-vanilla against vanilla detections (eval adds zero branches)


def _request_outputs(inference, lm, pixels, mask, caption):
    """`predict` on one request and the model's raw output of it."""
    captured = {}
    hook = lm.model.register_forward_hook(lambda m, a, out: captured.__setitem__("out", out))
    try:
        result = inference.predict(lm, pixels, mask, caption)
    finally:
        hook.remove()
    return result, captured["out"]


def phase_vanilla(build_model, inference, transforms, msda_forward, msda_backward, card_line):
    """7a: the vanilla `groundingdino` served from a reference-format
    checkpoint through `load_model`, REQUEST_CAPTIONS as `predict` requests
    and the port's demo on a PPM of the main path's image; 7b: the same
    checkpoint in the ZiRa preset. Returns the forward kernel's launches in
    7a and in 7b."""
    from ziragroundingdino_torch.data.synthetic import write_ppm, write_vocab
    from ziragroundingdino_torch.scripts import inference_on_a_image
    from ziragroundingdino_torch.text.tokenizer import make_synthetic_vocab

    root = pathlib.Path(__file__).resolve().parent / "build" / "phase7"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t0 = time.time()
    model = build_model("groundingdino", device="cpu", seed=0)
    if any("adapter" in k for k in model.state_dict()):
        raise AssertionError("the vanilla model holds ZiRa tensors")
    torch.save({"model": model.state_dict()}, root / "groundingdino.pth")
    del model
    write_vocab(str(root / "vocab.txt"), make_synthetic_vocab(REQUEST_WORDS))
    write_ppm(str(root / "image.ppm"), synthetic_u8())
    ckpt, vocab, image = (str(root / n) for n in ("groundingdino.pth", "vocab.txt", "image.ppm"))
    log(f"vanilla: checkpoint ({(root / 'groundingdino.pth').stat().st_size / 2**30:.2f} GiB), "
        f"vocab and image written in {time.time() - t0:.1f} s")

    # 7a: load_model, requests, the demo
    msda_forward.launches = msda_backward.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    lm = inference.load_model(ckpt, vocab, preset="groundingdino", dtype="bfloat16")
    load_ms = (time.perf_counter() - t) * 1e3
    if lm.missing or lm.unexpected or lm.mismatched:
        raise AssertionError(f"vanilla load: missing {lm.missing[:5]}, unexpected "
                             f"{lm.unexpected[:5]}, mismatched {lm.mismatched[:5]}")
    _, (pixels, mask), _ = transforms.load_image(image)
    cfg = lm.cfg
    n_layers = cfg.enc_layers + cfg.dec_layers
    request_ms, outs = [], []
    for caption in REQUEST_CAPTIONS:
        before = msda_forward.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        (boxes, scores, phrases), out = _request_outputs(inference, lm, pixels, mask, caption)
        torch.cuda.synchronize()
        request_ms.append((time.perf_counter() - t) * 1e3)
        outs.append(out)
        if msda_forward.launches - before != n_layers:
            raise AssertionError(f"vanilla request launched msda_forward "
                                 f"{msda_forward.launches - before} times, not {n_layers}")
        logits, pboxes = out["pred_logits"], out["pred_boxes"]
        if not (torch.isfinite(logits).all() and torch.isfinite(pboxes).all()):
            raise AssertionError("non-finite vanilla detections")
        if tuple(pboxes.shape) != (1, cfg.num_queries, 4):
            raise AssertionError(f"vanilla pred_boxes shape {tuple(pboxes.shape)}")
    caption = REQUEST_CAPTIONS[0]
    want = inference.predict(lm, pixels, mask, caption, box_threshold=0.0)
    printed = io.StringIO()  # the demo prints its 900 boxes: kept out of this log
    with contextlib.redirect_stdout(printed):
        pred = inference_on_a_image.main(["-c", "groundingdino", "-p", ckpt, "--vocab", vocab,
                                          "-i", image, "-t", caption, "-o", str(root / "demo"),
                                          "--box-threshold", "0.0"])
    saved = json.loads((root / "demo" / "pred.json").read_text())
    drawn = transforms.read_image(str(root / "demo" / "pred.ppm"))
    box_gap = float(np.abs(np.asarray(saved["boxes"], np.float32) - want[0]).max())
    score_gap = float(np.abs(np.asarray(saved["scores"], np.float32) - want[1]).max())
    launches_a = msda_forward.launches
    peak = torch.cuda.max_memory_allocated()
    log(f"vanilla: load_model {load_ms:.1f} ms; {len(REQUEST_CAPTIONS)} requests at 800x1216, "
        f"per-request ms {[round(x, 2) for x in request_ms]} (first includes warm-up), median "
        f"{statistics.median(request_ms[1:]):.2f} ms, peak memory {peak / 2**30:.2f} GiB; demo: "
        f"{len(saved['boxes'])} boxes ({len(printed.getvalue())} bytes printed), "
        f"max |demo - predict| boxes {box_gap:.3e} scores "
        f"{score_gap:.3e}, annotated {drawn.shape}; msda_forward launches {launches_a} "
        f"({n_layers} a request), msda_backward {msda_backward.launches}; on {card_line}")
    if saved != pred or saved["phrases"] != want[2] or len(saved["boxes"]) != cfg.num_queries:
        raise AssertionError("the demo's detections are not predict's")
    if box_gap > 0 or score_gap > 0:
        raise AssertionError(f"the demo's boxes differ from predict's by {box_gap}, {score_gap}")
    if drawn.shape != synthetic_u8().shape:
        raise AssertionError(f"annotated image {drawn.shape}")
    if launches_a != n_layers * (len(REQUEST_CAPTIONS) + 2) or msda_backward.launches:
        raise AssertionError(f"vanilla serving launches {launches_a}, {msda_backward.launches}")
    del lm

    # 7b: the same checkpoint in the ZiRa preset (the Queue 3 repair)
    msda_forward.launches = 0
    lmz = inference.load_model(ckpt, vocab, preset="dualzerorepbranchgroundingdino",
                               dtype="bfloat16")
    zira_keys = sorted(k for k in lmz.model.state_dict() if "adapter" in k)
    if sorted(lmz.missing) != zira_keys or lmz.unexpected or lmz.mismatched:
        raise AssertionError(f"ZiRa load: missing {lmz.missing[:5]} (want the {len(zira_keys)} "
                             f"ZiRa keys), unexpected {lmz.unexpected[:5]}")
    _, zout = _request_outputs(inference, lmz, pixels, mask, REQUEST_CAPTIONS[-1])
    launches_b = msda_forward.launches
    same_idx = torch.equal(zout["topk_idx"], outs[-1]["topk_idx"])
    gaps = {k: float((zout[k].float() - outs[-1][k].float()).abs().max())
            for k in ("pred_logits", "pred_boxes")}
    log(f"vanilla into ZiRa: missing = the {len(zira_keys)} ZiRa keys, nothing unexpected; "
        f"top-900 equal={same_idx}, max abs gap " + ", ".join(f"{k} {v:.3e}" for k, v in
                                                             gaps.items())
        + f" (tol {VANILLA_TOL}); msda_forward launches {launches_b}")
    if not same_idx or max(gaps.values()) > VANILLA_TOL or launches_b != n_layers:
        raise AssertionError(f"ZiRa from the vanilla checkpoint: topk {same_idx}, gaps {gaps}, "
                             f"launches {launches_b}")
    del lmz
    shutil.rmtree(root, ignore_errors=True)
    return launches_a, launches_b, {"request_median_ms": statistics.median(request_ms[1:]),
                                    "request_ms": request_ms, "load_model_ms": load_ms,
                                    "peak_memory_gib": peak / 2**30}


def _zira_state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _check_family_merge(label, model, trained, merged_names, zira):
    """Every non-ZiRa tensor bitwise unchanged; each merged freeze tensor the
    formula of its module kind at MERGE_TOL (relative to max(1, |want|)).
    Returns the largest error."""
    sd = model.state_dict()
    changed = [k for k, v in sd.items() if "adapter" not in k and not torch.equal(v, trained[k])]
    if changed:
        raise AssertionError(f"{label}: the merge changed non-ZiRa tensors {changed[:5]}")
    worst = 0.0
    for name in merged_names:
        mod = model.get_submodule(name)
        p = f"{name}."
        if isinstance(mod, zira.ZeroConvBN):
            t = trained[p + "branch.bn.weight"] / torch.sqrt(trained[p + "branch.bn.running_var"]
                                                              + zira.BN_EPS)
            want = {"freeze_conv.weight": trained[p + "freeze_conv.weight"]
                    + trained[p + "branch.conv.weight"] * t[:, None, None, None],
                    "freeze_conv.bias": trained[p + "freeze_conv.bias"] + trained[p + "branch.bn.bias"]
                    + (trained[p + "branch.conv.bias"] - trained[p + "branch.bn.running_mean"]) * t}
        elif isinstance(mod, zira.RepZeroLoRA):
            want = {"freeze_linear.weight": trained[p + "freeze_linear.weight"]
                    + trained[p + "scaling"] * (trained[p + "up.weight"]
                                                @ trained[p + "down.weight"])}
        else:
            freeze = "freeze_linear" if isinstance(mod, zira.RepZeroLinear) else "freeze_conv"
            want = {f"{freeze}.{part}": trained[f"{p}{freeze}.{part}"]
                    + trained[p + "scaling"] * trained[p + part] for part in ("weight", "bias")}
        for k, w in want.items():
            err = float((sd[p + k] - w).abs().max() / max(1.0, float(w.abs().max())))
            worst = max(worst, err)
            if err > MERGE_TOL:
                raise AssertionError(f"{label}: {name}.{k} off by {err}")
    return worst


def _encoder_outputs(model, TextEncoderOnly, batch, text, train):
    got = {}
    hook = model.transformer.encoder.register_forward_hook(
        lambda m, a, o: got.update(image=o[0], text=o[1]))
    try:
        with torch.no_grad():
            model(batch["pixels"], batch["mask"], text, train=train)
            got["encoded_text"] = TextEncoderOnly(model)(text, train=train)[0]
    finally:
        hook.remove()
    return got


def phase_family(build_model, optim, step, tokenizer_mod, transforms, pc, msda_forward,
                 msda_backward, card_line):
    """7c: each configuration of FAMILY at full width, seeded ZiRa weights,
    FAMILY_STEPS train steps on phase 5b's batch, then its merge and the
    checks. Returns {label: (forward, backward, binned launches)} and
    {label: its warm step, peak memory and merge time}."""
    launches, numbers = {}, {}
    for label, preset, extra in FAMILY:
        # one function call per configuration, so that its models, state
        # copies and activations are freed before the next one's peak
        launches[label], numbers[label] = _train_and_merge(
            label, preset, extra, build_model, optim, step, tokenizer_mod, transforms, pc,
            msda_forward, msda_backward, card_line)
        torch.cuda.empty_cache()
    return launches, numbers


def _train_and_merge(label, preset, extra, build_model, optim, step, tokenizer_mod, transforms,
                     pc, msda_forward, msda_backward, card_line):
    """One configuration of phase 7c; returns its launches and numbers."""
    from ziragroundingdino_torch.models import zira
    from ziragroundingdino_torch.models.groundingdino import TextEncoderOnly

    words = ["person", "dog", "cat", "car"]
    tok = tokenizer_mod.WordPieceTokenizer(tokenizer_mod.make_synthetic_vocab(words))
    t0 = time.time()
    model = build_model(preset, device="cuda", dtype="bfloat16", seed=0, **extra)
    _seeded_rep_modules(model)
    cfg = model.cfg
    optim.set_trainable(model, optim.trainable_patterns_for_cfg(cfg))
    opt = optim.Optimizer(model, pc.OptimizerConfig(), pc.ScheduleConfig())
    tb = tokenizer_mod.tokenize_captions(tok, [" . ".join(words) + " ."],
                                         max_text_len=cfg.max_text_len,
                                         max_categories=cfg.max_categories)
    pixels, mask = synthetic_image(transforms, pc)
    batch = train_batch(tb, pixels, mask, "cuda", n_labels=len(words))
    text = {k: batch[k] for k in step.TEXT_KEYS}
    gen = torch.Generator(device="cuda").manual_seed(0)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if not p.requires_grad}
    n_layers = cfg.enc_layers + cfg.dec_layers
    step_ms = []
    torch.cuda.synchronize()
    build_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    msda_forward.launches = msda_backward.launches = msda_backward.binned_launches = 0
    matched = matcher_counts()
    for i in range(FAMILY_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = step.train_step(model, opt, batch, gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        if not np.isfinite(metrics["total_loss"].item()):
            raise AssertionError(f"{label}: step {i} loss {metrics['total_loss'].item()}")
    lsap = check_matcher(label, matched, FAMILY_STEPS)
    got = (msda_forward.launches, msda_backward.launches, msda_backward.binned_launches)
    peak = torch.cuda.max_memory_allocated()
    want = (_forward_launches(cfg) * FAMILY_STEPS, n_layers * FAMILY_STEPS,
            cfg.enc_layers * FAMILY_STEPS)
    if got != want:
        raise AssertionError(f"{label}: msda launches {got}, not {want}")
    changed = [n for n, p in model.named_parameters()
               if not p.requires_grad and not torch.equal(p.detach(), frozen[n])]
    if changed:
        raise AssertionError(f"{label}: frozen parameters changed {changed[:5]}")
    losses = sorted(k for k in metrics if k.startswith("loss_") and "adapter" in k)

    # the merge: exact reparameterisations are checked on an eval batch too
    exact = label in ("repgroundingdino", "lora")
    trained = _zira_state(model)
    if exact:
        before = _encoder_outputs(model, TextEncoderOnly, batch, text, True)
        unmerged = _encoder_outputs(model, TextEncoderOnly, batch, text, False)
    t = time.perf_counter()
    merged = zira.rep_merge(model, scale_reset=zira.scale_reset_for_cfg(cfg))
    if label == "repconvbn":
        if merged:
            raise AssertionError(f"rep_merge folded ZeroConvBN modules {merged}")
        merged = zira.rep_merge_convbn(model)
    torch.cuda.synchronize()
    merge_ms = (time.perf_counter() - t) * 1e3
    n_lang = 0 if model.lang_adapter is None else 1
    if len(merged) != n_lang + cfg.num_feature_levels:
        raise AssertionError(f"{label}: merged {merged}")
    merge_err = _check_family_merge(label, model, trained, merged, zira)
    effect = {}
    if exact:
        after = _encoder_outputs(model, TextEncoderOnly, batch, text, False)
        effect = {k: (_rel_err(after[k], before[k]), _rel_err(unmerged[k], before[k]))
                  for k in before}
        for k, (err, eff) in effect.items():
            if err > MERGE_BF16_TOL or eff < MERGE_EFFECT * err:
                raise AssertionError(f"{label}: merge on the batch, {k}: error {err}, "
                                     f"effect {eff}")
    numbers = {"warm_step_ms": statistics.median(step_ms[1:]), "step_ms": step_ms,
               "peak_memory_gib": peak / 2**30, "merge_ms": merge_ms, "lsap_launches": lsap}
    log(f"family {label} ({preset}{', ' + str(extra) if extra else ''}): built in "
        f"{build_s:.1f} s; {len(opt.params)} trainable tensors; {FAMILY_STEPS} steps at "
        f"800x1216 bf16, per-step ms {[round(x, 2) for x in step_ms]} (warm "
        f"{numbers['warm_step_ms']:.2f}), peak {peak / 2**30:.2f} GiB; ZILs {losses}; "
        f"msda launches (forward, backward, binned) {got}; merged {len(merged)} modules in "
        f"{merge_ms:.2f} ms, largest rel err {merge_err:.2e}"
        + ("; after vs before (effect): " + ", ".join(
            f"{k} {e:.2e} ({x:.2e})" for k, (e, x) in effect.items()) if effect else "")
        + f"; on {card_line}")
    return got, numbers


# ---------------------------------------------------------------------------
# 8. the PET baselines and CAT at full width
# ---------------------------------------------------------------------------

PET_PRESETS = ("dtgroundingdino", "finetune", "linearprobe", "prompttune", "berttune",
               "projecttune", "catgroundingdino")
PET_STEPS = 2
# presets in which no gradient reaches MSDA (the trainable heads of
# linearprobe read the decoder's output and the detached anchors; prompttune
# trains nothing), so their steps launch no `msda_backward`
PET_NO_MSDA_GRAD = ("linearprobe", "prompttune")
# trainable tensors whose gradient is 0 by construction, so the backward
# may leave them none: with one expert (`num_experts=1`) CAT's MoE gate is a
# softmax over one logit; BERT's attention key biases shift every logit of
# a softmax row alike (0 in exact arithmetic: bf16 rounding leaves 0 or a
# few ulps)
ZERO_GRADIENT = ("prompt_adapter.adapter_moe.w_gate", "prompt_adapter.adapter_moe.w_noise",
                 "attention.self.key.bias")
PET_TASKS = tuple(LIFECYCLE_TASKS)  # phase 6's synthetic tasks
PET_ITERS, PET_BATCH = 2, 2


def _seeded_pet_modules(model, seed: int = 5):
    """The zero-init weights of the PET and CAT modules drawn so that they
    act: the adapters' up projections (`adapter_up`, `linear`,
    `project_out`) and the MoE experts' `fc2` from N(0, 1 / fan_in), their
    biases from N(0, 0.01), the MoE gate `w_gate` from N(0, 1 / d) and
    `w_noise` from N(0, 0.01 / d); the box heads' last layers (`bbox_embed`,
    `enc_out_bbox_embed`) from N(0, 0.01 / fan_in) and N(0, 0.01), so that
    the first step's gradient reaches their first layers where they train
    (later steps' two-stage queries can all sit where the box saturates).
    `cls_linear` starts random already."""
    from ziragroundingdino_torch.models.adapters import Adapter, LinearAdapter, TransformerAdapter
    from ziragroundingdino_torch.models.moe import MoE

    g = torch.Generator().manual_seed(seed)

    def draw(t, std):
        t.copy_(std * torch.randn(t.shape, generator=g))

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Adapter):
                ups = [mod.adapter_up]
            elif isinstance(mod, LinearAdapter):
                ups = [mod.linear]
            elif isinstance(mod, TransformerAdapter):
                ups = [mod.project_out]
            elif isinstance(mod, MoE):
                ups = [e.fc2 for e in mod.experts]
                draw(mod.w_gate, mod.w_gate.shape[0] ** -0.5)
                draw(mod.w_noise, 0.01 * mod.w_noise.shape[0] ** -0.5)
            else:
                continue
            for lin in ups:
                draw(lin.weight, lin.in_features ** -0.5)
                draw(lin.bias, 0.01)
        for lin in (model.bbox_embed[0].layers[-1], model.transformer.enc_out_bbox_embed.layers[-1]):
            draw(lin.weight, 0.1 * lin.in_features ** -0.5)
            draw(lin.bias, 0.01)


def phase_pet(build_model, inference, optim, step, tokenizer_mod, transforms, pc, msda_forward,
              msda_backward, card_line):
    """8a: each of PET_PRESETS at full width, its zero-init weights seeded:
    one `predict` request on phase 5's image, PET_STEPS train steps with
    dropout on phase 5b's batch, and the checks. Returns {preset: launches}
    and {preset: numbers}."""
    launches, numbers = {}, {}
    for preset in PET_PRESETS:
        launches[preset], numbers[preset] = _serve_and_train(
            preset, build_model, inference, optim, step, tokenizer_mod, transforms, pc,
            msda_forward, msda_backward, card_line)
        torch.cuda.empty_cache()
    return launches, numbers


def _serve_and_train(preset, build_model, inference, optim, step, tokenizer_mod, transforms, pc,
                     msda_forward, msda_backward, card_line):
    """One preset of phase 8a; returns (request launches, train launches)
    and its numbers."""
    t0 = time.time()
    model = build_model(preset, device="cuda", dtype="bfloat16", seed=0)
    _seeded_pet_modules(model)
    cfg = model.cfg
    n_layers = cfg.enc_layers + cfg.dec_layers
    torch.cuda.synchronize()
    build_s = time.time() - t0

    # one request
    lm = inference.LoadedModel(model=model, tokenizer=tokenizer_mod.WordPieceTokenizer(
        tokenizer_mod.make_synthetic_vocab(REQUEST_WORDS)))
    pixels, mask = synthetic_image(transforms, pc)
    msda_forward.launches = msda_backward.launches = msda_backward.binned_launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, out = _request_outputs(inference, lm, pixels, mask, REQUEST_CAPTIONS[0])
    torch.cuda.synchronize()
    request_ms = (time.perf_counter() - t) * 1e3
    served = (msda_forward.launches, msda_backward.launches)
    if served != (n_layers, 0):
        raise AssertionError(f"{preset}: a request launched (forward, backward) {served}")
    if not (torch.isfinite(out["pred_logits"]).all() and torch.isfinite(out["pred_boxes"]).all()):
        raise AssertionError(f"{preset}: non-finite detections")
    if tuple(out["pred_boxes"].shape) != (1, cfg.num_queries, 4):
        raise AssertionError(f"{preset}: pred_boxes shape {tuple(out['pred_boxes'].shape)}")

    # PET_STEPS train steps
    optim.set_trainable(model, optim.trainable_patterns_for_cfg(cfg), freeze_all=cfg.freeze_all)
    opt = optim.Optimizer(model, pc.OptimizerConfig(), pc.ScheduleConfig())
    words = ["person", "dog", "cat", "car"]
    tok = tokenizer_mod.WordPieceTokenizer(tokenizer_mod.make_synthetic_vocab(words))
    tb = tokenizer_mod.tokenize_captions(tok, [" . ".join(words) + " ."],
                                         max_text_len=cfg.max_text_len,
                                         max_categories=cfg.max_categories)
    batch = train_batch(tb, pixels, mask, "cuda", n_labels=len(words))
    gen = torch.Generator(device="cuda").manual_seed(0)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if not p.requires_grad}
    start = {n: p.detach().clone() for n, p in opt.params.items()}
    ungraded = record_gradients(opt)
    step_ms = []
    torch.cuda.reset_peak_memory_stats()
    msda_forward.launches = msda_backward.launches = msda_backward.binned_launches = 0
    matched = matcher_counts()
    for i in range(PET_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = step.train_step(model, opt, batch, gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        bad = {k: v.item() for k, v in metrics.items() if not torch.isfinite(v).all()}
        if bad:
            raise AssertionError(f"{preset}: step {i} non-finite {bad}")
    lsap = check_matcher(preset, matched, PET_STEPS)
    peak = torch.cuda.max_memory_allocated()
    trained = (msda_forward.launches, msda_backward.launches, msda_backward.binned_launches)
    grads = 0 if preset in PET_NO_MSDA_GRAD else 1
    want = (n_layers * PET_STEPS, grads * n_layers * PET_STEPS,
            grads * cfg.enc_layers * PET_STEPS)
    if trained != want:
        raise AssertionError(f"{preset}: train msda launches {trained}, not {want}")
    if cfg.use_adapter and not metrics["loss_adapter"].item() > 0:
        raise AssertionError(f"{preset}: loss_adapter {metrics['loss_adapter'].item()}")
    changed = [n for n, p in model.named_parameters()
               if not p.requires_grad and not torch.equal(p.detach(), frozen[n])]
    if changed:
        raise AssertionError(f"{preset}: frozen parameters changed {changed[:5]}")
    no_grad = sorted(ungraded())
    missed = [n for n in no_grad if not n.endswith(ZERO_GRADIENT)]
    if missed:
        raise AssertionError(f"{preset}: the backward gave no gradient to trainable {missed}")
    still = sorted(n for n, p in opt.params.items() if torch.equal(p.detach(), start[n]))
    if still:
        raise AssertionError(f"{preset}: trainable parameters did not move: {still[:5]}")
    if preset == "finetune":
        for part in ("backbone.0.layers.0.blocks.0.attn.qkv.weight",
                     "bert.encoder.layer.0.attention.self.query.weight"):
            if part not in opt.params:
                raise AssertionError(f"finetune: {part} does not train")
    if preset == "prompttune" and (opt.params or metrics["grad_norm"].item() != 0.0):
        raise AssertionError("prompttune trained")
    losses = {k: round(v.item(), 4) for k, v in metrics.items() if k in
              ("total_loss", "loss_adapter")}
    numbers = {"request_ms": request_ms, "step_ms": step_ms, "warm_step_ms": step_ms[-1],
               "peak_memory_gib": peak / 2**30, "trainable_tensors": len(opt.params),
               "trainable_m": sum(p.numel() for p in opt.params.values()) / 1e6,
               "train_launches": trained, "lsap_launches": lsap}
    log(f"pet {preset}: built in {build_s:.1f} s; request {request_ms:.1f} ms ({served[0]} "
        f"msda_forward launches); {len(opt.params)} trainable tensors "
        f"({numbers['trainable_m']:.2f} M), {len(no_grad)} without a gradient, all "
        f"zero by construction {no_grad}, none unmoved; {PET_STEPS} steps at 800x1216 bf16, "
        f"per-step ms {[round(x, 2) for x in step_ms]}, peak {peak / 2**30:.2f} GiB; msda "
        f"launches (forward, backward, binned) {trained}; losses {losses}; on {card_line}")
    return (served[0], trained), numbers


def phase_pet_driver(build_model, msda_forward, msda_backward, card_line):
    """8b: `scripts/train_odinw.main --preset dtgroundingdino` at full width
    from a seeded reference-format checkpoint of the dt model (its CET
    adapter seeded) on phase 6's two synthetic tasks: PET_ITERS steps a task
    at batch PET_BATCH, the second task's caption with the first task's
    classes added (`use_add_names`), prompt capture, the eval of both.
    Checks the launches, that only the CET adapter changed, the prompts and
    the learned-name captions. Returns the launches and the numbers."""
    from ziragroundingdino_torch.data import synthetic
    from ziragroundingdino_torch.scripts import train_odinw
    from ziragroundingdino_torch.text.tokenizer import make_synthetic_vocab
    from ziragroundingdino_torch.train import incremental

    root = pathlib.Path(__file__).resolve().parent / "build" / "phase8"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t0 = time.time()
    model = build_model("dtgroundingdino", device="cpu", seed=0)
    _seeded_pet_modules(model)
    n_layers, n_enc = model.cfg.enc_layers + model.cfg.dec_layers, model.cfg.enc_layers
    torch.save({"model": model.state_dict()}, root / "ckpt.pth")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    del model
    classes = [c for name in PET_TASKS for c in LIFECYCLE_TASKS[name][0]]
    synthetic.write_vocab(str(root / "vocab.txt"), make_synthetic_vocab(classes))
    for i, name in enumerate(PET_TASKS):
        cls, n_train, n_test = LIFECYCLE_TASKS[name]
        synthetic.write_odinw_task(str(root / "data"), name, cls, n_train, n_test,
                                   LIFECYCLE_ORIG, seed=100 + 10 * i)
    out = root / "out"
    args = ["--checkpoint", str(root / "ckpt.pth"), "--vocab", str(root / "vocab.txt"),
            "--datasets-root", str(root / "data"), "--tasks", ",".join(PET_TASKS),
            "--output-dir", str(out), "--batch-size", str(PET_BATCH),
            "--max-iter", str(PET_ITERS), "--checkpoint-period", str(PET_ITERS),
            "--preset", "dtgroundingdino"]
    captions = []
    augment = incremental.augment_caption_with_learned_names

    def recording(names, learned, *a, **kw):
        captions.append(augment(names, learned, *a, **kw))
        return captions[-1]

    incremental.augment_caption_with_learned_names = recording
    setup_s = time.time() - t0
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        msda_forward.launches = msda_backward.launches = msda_backward.binned_launches = 0
        matched = matcher_counts()
        t = time.perf_counter()
        report = train_odinw.main(args)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
    finally:
        incremental.augment_caption_with_learned_names = augment
    launches = (msda_forward.launches, msda_backward.launches, msda_backward.binned_launches)
    check_matcher("phase 8b", matched, PET_ITERS * len(PET_TASKS))
    peak = torch.cuda.max_memory_allocated()
    steps = PET_ITERS * len(PET_TASKS)
    batches = sum(-(-LIFECYCLE_TASKS[n][2] // PET_BATCH) for n in PET_TASKS)
    want = (n_layers * (steps + batches) + n_enc * steps, n_layers * steps, n_enc * steps)
    log(f"pet driver: dtgroundingdino through train_odinw in {run_s:.1f} s ({steps} steps, "
        f"{batches} eval batches); msda launches {launches}; captions {captions}; "
        f"report {report}; peak {peak / 2**30:.2f} GiB; on {card_line}")
    if launches != want:
        raise AssertionError(f"pet driver: msda launches {launches}, not {want}")
    keys = {f"AP/{n}" for n in PET_TASKS} | {"avg_AP"}
    if set(report) != keys or not all(np.isfinite(v) for v in report.values()):
        raise AssertionError(f"pet driver report {report}")
    # the first task's caption is its classes; the second's adds them
    if len(captions) != 2 or not set(captions[0]) < set(captions[1]):
        raise AssertionError(f"the second task's caption lacks the first's classes: {captions}")
    for name in PET_TASKS:
        final = torch.load(out / name / "state_final.pt", map_location="cpu", weights_only=True)
        params = final["params"]
        changed = sorted(k for k, v in params.items() if not torch.equal(v, before[k]))
        if not changed or any(not k.startswith("cet_adapter.") for k in changed):
            raise AssertionError(f"task {name} changed {changed[:5]}")
        missing = {f"-{c}-" for c in LIFECYCLE_TASKS[name][0]} - set(final["prompt_memory"])
        if missing:
            raise AssertionError(f"task {name}: no prompt for {missing}")
        before = params
    shutil.rmtree(root, ignore_errors=True)
    return launches, {"run_s": run_s, "setup_s": setup_s, "peak_memory_gib": peak / 2**30,
                      "report": report}


# ---------------------------------------------------------------------------
# 9. the Predictor: one CUDA graph per key
# ---------------------------------------------------------------------------

PREDICTOR_CLASSES = ["person", "dog", "cat", "car"]  # request (a)'s 4 categories
PREDICTOR_REPEATS = 8  # requests of (a)
PREDICTOR_IMAGES = ((800, 1199), (600, 800), (480, 640))  # (h, w) of request (b)'s images
# (d): 36 one-token names and their dots, over 64 tokens: text bucket 128
LONG_CLASSES = (REQUEST_WORDS * 2)[:36]


def predictor_image(h: int, w: int, seed: int) -> np.ndarray:
    """A seeded uint8 image: phase 5's for 800x1199 with seed 0."""
    if (h, w, seed) == (800, 1199, 0):
        return synthetic_u8()
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)


class _CaptureCount:
    """While installed, `torch.cuda.graph` records, per capture, the
    `msda_forward` launches made inside it (the kernels the graph holds)."""

    def __init__(self, msda_forward):
        self.msda_forward = msda_forward
        self.launches = []

    def install(self):
        graph, count = torch.cuda.graph, self

        class counted(graph):
            def __enter__(self):
                self._before = count.msda_forward.launches
                return super().__enter__()

            def __exit__(self, *exc):
                out = super().__exit__(*exc)
                count.launches.append(count.msda_forward.launches - self._before)
                return out

        self._graph = graph
        torch.cuda.graph = counted

    def restore(self):
        torch.cuda.graph = self._graph


def _pool_mib(pool) -> float | None:
    """MiB of the segments of the graphs' shared memory pool, from the
    allocator's snapshot (None where the snapshot does not name pools)."""
    segments = torch.cuda.memory_snapshot()
    if not segments or "segment_pool_id" not in segments[0]:
        return None
    return sum(s["total_size"] for s in segments
               if tuple(s["segment_pool_id"]) == tuple(pool)) / 2**20


def _replay_vs_eager(predictor, key, msda_forward) -> dict:
    """The key's graph outputs (the last replay) against the eager forward
    and post-processing of the same static inputs: bitwise, or within
    BF16_REL_TOL with equal labels (cuBLAS may pick other algorithms under
    capture). The eager run's launches are a comparison's, not the path's:
    they are taken off the count."""
    prog = predictor._compiled[key]
    before = msda_forward.launches
    with torch.inference_mode():
        eager = predictor._run(prog)
    torch.cuda.synchronize()
    msda_forward.launches = before
    scores, labels, boxes = prog.outputs
    bitwise = all(torch.equal(a, b) for a, b in zip(prog.outputs, eager))
    score_err = (scores - eager[0]).abs().max().item()
    box_err = ((boxes - eager[2]).abs().max() / boxes.abs().max().clamp(min=1.0)).item()
    labels_equal = torch.equal(labels, eager[1])
    if not bitwise and not (labels_equal and score_err <= BF16_REL_TOL
                            and box_err <= BF16_REL_TOL):
        raise AssertionError(f"predictor {key}: replay vs eager: scores {score_err:.3e}, boxes "
                             f"{box_err:.3e} of their scale, labels equal {labels_equal}")
    return {"bitwise": bitwise, "score_max_abs_err": score_err, "box_max_rel_err": box_err,
            "labels_equal": labels_equal}


def _against_predict(inference, transforms, pc, lm, result, caption_classes) -> dict:
    """Request (a)'s detections against `predict` on the same image: the
    post-processing of the Predictor (per-category logits, top-k, scaling)
    applied to `predict`'s raw output. `predict` tokenises into 64 tokens
    (no text bucket) and the Predictor into 32, so bf16 sums differ; the
    sorted scores are held at BF16_REL_TOL and the best detection's label
    and box (within 1% of the image's size) must agree."""
    from ziragroundingdino_torch.eval.postprocess import scale_to_original, top_k_detections
    from ziragroundingdino_torch.text.masks import recover_to_cls_logits
    from ziragroundingdino_torch.text.tokenizer import build_captions, tokenize_captions

    pixels, mask = synthetic_image(transforms, pc)
    caption = build_captions(caption_classes)
    (_, _, _), out = _request_outputs(inference, lm, pixels, mask, caption)
    tb = tokenize_captions(lm.tokenizer, [caption], max_text_len=lm.cfg.max_text_len,
                           max_categories=4)
    t = tb.input_ids.shape[1]
    c2t = torch.from_numpy(tb.cate_to_token_mask).cuda()
    det = top_k_detections(recover_to_cls_logits(out["pred_logits"][..., :t], c2t, fill=-100.0),
                           out["pred_boxes"], k=len(result["scores"]))
    orig = torch.tensor([[800, 1199]], device="cuda")
    want_scores = det["scores"][0].cpu().numpy()
    want_boxes = scale_to_original(det["boxes_cxcywh"], orig)[0].cpu().numpy()
    want_labels = det["labels"][0].cpu().numpy()
    score_err = float(np.abs(np.sort(result["scores"]) - np.sort(want_scores)).max())
    # the Predictor's best detection among predict's ten best: same label,
    # box within 1% of the image's width (near-equal scores may swap ranks)
    box_err = min((float(np.abs(result["boxes"][0] - b).max()) / 1199
                   for b, lab in zip(want_boxes[:10], want_labels[:10])
                   if int(lab) == int(result["labels"][0])), default=float("inf"))
    top10 = len({tuple(np.round(b, 0)) for b in result["boxes"][:10]}
                & {tuple(np.round(b, 0)) for b in want_boxes[:10]})
    log(f"predictor vs predict, request (a): sorted scores max abs diff {score_err:.3e}; the "
        f"best detection's box within {box_err:.3e} of the width of one of predict's ten best "
        f"with its label; {top10} of the ten best boxes equal to the pixel")
    if not (score_err <= BF16_REL_TOL and box_err <= 1e-2):
        raise AssertionError(f"predictor request (a) vs predict: sorted scores {score_err:.3e}, "
                             f"best detection {box_err:.3e}")
    return {"sorted_score_max_abs_diff": score_err, "best_box_rel_diff": box_err,
            "top10_boxes_equal": top10}


def phase_predictor(build_model, inference, tokenizer_mod, transforms, pc, msda_forward,
                    card_line, profile_dir=None):
    """The Predictor at full width (dualzerorepbranchgroundingdino, bf16,
    seeded weights): (a) phase 5's image with a 4-category caption, batch 1,
    PREDICTOR_REPEATS requests; (b) three images of three sizes with three
    captions, batch bucket 4; (c) 8 images, batch 8; (d) a caption over 64
    tokens, text bucket 128. Per key: one capture holding 12 msda_forward
    launches, the replay against the eager forward of the same inputs, the
    request ms (median, host clock around the call) and img/s; request (a)
    against `predict`; the peak memory with every graph alive and the shared
    pool's size; with `profile_dir`, one replayed request under the
    profiler. Returns the launches and the numbers."""
    from ziragroundingdino_torch.utils.predictor import WARMUP_RUNS, Predictor

    t0 = time.time()
    model = build_model("dualzerorepbranchgroundingdino", device="cuda", dtype="bfloat16",
                        seed=0)
    tok = tokenizer_mod.WordPieceTokenizer(tokenizer_mod.make_synthetic_vocab(REQUEST_WORDS))
    predictor = Predictor(model, tok)
    n_layers = model.cfg.enc_layers + model.cfg.dec_layers
    big = predictor_image(800, 1199, 0)
    requests = {
        "a": ([big], [PREDICTOR_CLASSES], PREDICTOR_REPEATS),
        "b": ([predictor_image(h, w, i) for i, (h, w) in enumerate(PREDICTOR_IMAGES)],
              [PREDICTOR_CLASSES, ["zebra", "horse", "bird"], ["traffic", "light", "boat"]], 4),
        "c": ([predictor_image(800, 1199, i) for i in range(8)],
              [PREDICTOR_CLASSES[: 1 + i % 4] for i in range(8)], 4),
        "d": ([big], [LONG_CLASSES], 4),
    }
    counter = _CaptureCount(msda_forward)
    counter.install()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    msda_forward.launches = 0
    numbers, keys = {}, {}
    try:
        for name, (images, classes, repeats) in requests.items():
            ms, captures = [], len(counter.launches)
            for _ in range(repeats):
                torch.cuda.synchronize()
                t = time.perf_counter()
                result = predictor(images, classes, score_threshold=0.0)
                ms.append((time.perf_counter() - t) * 1e3)
            key = list(predictor._compiled)[-1]
            new = counter.launches[captures:]
            if len(new) != 1 or new[0] != n_layers:
                raise AssertionError(f"predictor request ({name}) {key}: captures holding "
                                     f"{new} msda_forward launches, not one holding {n_layers}")
            for r in result:
                if not (np.isfinite(r["scores"]).all() and np.isfinite(r["boxes"]).all()):
                    raise AssertionError(f"predictor request ({name}): non-finite detections")
            for img, r in zip(images, result):
                h, w = img.shape[:2]
                if not (len(r["scores"]) == predictor.select_k and (r["boxes"] >= 0).all()
                        and (r["boxes"][:, 0::2] <= w).all()
                        and (r["boxes"][:, 1::2] <= h).all()):
                    raise AssertionError(f"predictor request ({name}): boxes outside the image")
            keys[name] = key
            numbers[name] = {
                "key": [key[0], list(key[1]), key[2], key[3]], "images": len(images),
                "request_ms": ms, "request_median_ms": statistics.median(ms[1:]),
                "img_per_s": len(images) / statistics.median(ms[1:]) * 1e3,
                "first_request_ms": ms[0],
                "replay_vs_eager": _replay_vs_eager(predictor, key, msda_forward)}
            log(f"predictor request ({name}): key {key}, {len(images)} images, request ms "
                f"{[round(x, 2) for x in ms]} (first: warm-up and capture), median "
                f"{numbers[name]['request_median_ms']:.2f}, "
                f"{numbers[name]['img_per_s']:.2f} img/s; replay vs eager "
                f"{numbers[name]['replay_vs_eager']}")
            if name == "a":  # a comparison's launches: off the count
                before = msda_forward.launches
                lm = inference.LoadedModel(model=model, tokenizer=tok)
                numbers[name]["against_predict"] = _against_predict(
                    inference, transforms, pc, lm, result[0], PREDICTOR_CLASSES)
                msda_forward.launches = before
        launches = msda_forward.launches
    finally:
        counter.restore()
    if keys["d"][2] != 128 or len(set(keys.values())) != len(keys):
        raise AssertionError(f"predictor keys {keys}")
    if len(predictor._compiled) != len(keys) or len(counter.launches) != len(keys):
        raise AssertionError(f"{len(counter.launches)} captures for {len(keys)} keys")
    # per key: the warm-up runs and the capture go through the wrapper; the
    # replays launch the captured kernels without it
    if launches != n_layers * (WARMUP_RUNS + 1) * len(keys):
        raise AssertionError(f"predictor: {launches} msda_forward launches, not "
                             f"{n_layers} x ({WARMUP_RUNS} warm-up runs + 1 capture) per key")
    numbers["replays"] = {k: v[2] - 1 for k, v in requests.items()}
    peak = torch.cuda.max_memory_allocated()
    numbers["peak_memory_gib"] = peak / 2**30
    pool = _pool_mib(predictor._pool)
    numbers["graph_pool_mib"] = pool
    numbers["setup_s"] = time.time() - t0
    log(f"predictor: {len(keys)} keys, peak memory {peak / 2**30:.2f} GiB with every graph "
        f"alive, shared pool {pool if pool is None else round(pool, 1)} MiB; on {card_line}")
    if profile_dir is not None:  # one replayed request of each key
        for name, (images, classes, _) in requests.items():
            numbers[name]["profile"] = profile_window(
                f"replayed request ({name})", lambda: predictor(images, classes), 2,
                profile_dir / f"predictor_{name}_trace.json.gz", card_line)
    return launches, numbers


# ---------------------------------------------------------------------------
# 10. every architecture switch at full width: GroundingDINO-B, ResNet-50
# with learned positions, Swin-L, the ablation switches, `train_odinw` on Swin-B
# ---------------------------------------------------------------------------

SWIN_B, SWIN_L = "swin_B_384_22k", "swin_L_384_22k"
REMAT = {"use_checkpoint": True, "use_transformer_ckpt": True}
# a step against another from identical weights and generator, each
# trainable gradient times its own largest magnitude: `msda_backward` adds
# d_value with float atomics in no fixed order and rounds it to bf16, so a
# one-ulp f32 difference may move a bf16 d_value by 2**-8 of itself; that
# carries into every gradient upstream of the encoder (the conv branches).
# Held for a step without remat against a second one (the floor) and for
# one with remat; BF16_REL_TOL's bound
REMAT_GRAD_TOL = 1e-2
SWIN_B_REQUESTS = 4
# (switch, the parameter names it takes away when off; none: it changes
# only how BERT reads the text)
ABLATIONS = (("use_text_enhancer", ("transformer.encoder.text_layers.",)),
             ("use_fusion_layer", ("transformer.encoder.fusion_layers.",)),
             ("use_text_cross_attention", (".ca_text.", ".catext_norm.")),
             ("embed_init_tgt", ("transformer.tgt_embed.",)),
             ("sub_sentence_present", ()))
# the frozen BN tensors and learned tables that `finetune` trains on ResNet
FROZEN_BN = ("running_mean", "running_var")


def _seeded_deformable(model, seed: int = 6):
    """The deformable layers' zero-init `sampling_offsets` and
    `attention_weights` kernels drawn from N(0, 0.01 / fan_in), as a trained
    checkpoint has them: at their init no gradient reaches the query, so
    none would reach the positions (`backbone.1`) that it adds."""
    from ziragroundingdino_torch.models.transformer import MSDeformAttn

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, MSDeformAttn):
                for lin in (mod.sampling_offsets, mod.attention_weights):
                    lin.weight.copy_(0.1 * torch.randn(lin.weight.shape, generator=g)
                                     / lin.in_features ** 0.5)


def _forward_launches(cfg) -> int:
    """`msda_forward` launches of one train step: every deformable layer's,
    and again each encoder layer's when the backward recomputes it."""
    return cfg.enc_layers + cfg.dec_layers + (cfg.enc_layers if cfg.use_transformer_ckpt else 0)


def _serve_once(label, preset, overrides, build_model, inference, tokenizer_mod, transforms, pc,
                msda_forward, msda_backward, card_line, seed_rep=False):
    """Build `preset` with `overrides` at full width (bf16, seeded weights;
    its ZiRa branches seeded with `seed_rep`), answer one `predict` request
    on phase 5's image: 12 `msda_forward` launches, no backward, finite
    detections of the right shapes. Returns its numbers and its config."""
    t0 = time.time()
    model = build_model(preset, device="cuda", dtype="bfloat16", seed=0, **overrides)
    if seed_rep:
        _seeded_rep_modules(model)
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    build_s = time.time() - t0
    lm = inference.LoadedModel(model=model, tokenizer=tokenizer_mod.WordPieceTokenizer(
        tokenizer_mod.make_synthetic_vocab(REQUEST_WORDS)))
    pixels, mask = synthetic_image(transforms, pc)
    torch.cuda.reset_peak_memory_stats()
    msda_forward.launches = msda_backward.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, out = _request_outputs(inference, lm, pixels, mask, REQUEST_CAPTIONS[0])
    torch.cuda.synchronize()
    request_ms = (time.perf_counter() - t) * 1e3
    peak = torch.cuda.max_memory_allocated()
    served = (msda_forward.launches, msda_backward.launches)
    n_layers = cfg.enc_layers + cfg.dec_layers
    if served != (n_layers, 0):
        raise AssertionError(f"{label}: a request launched (forward, backward) {served}")
    if not (torch.isfinite(out["pred_logits"]).all() and torch.isfinite(out["pred_boxes"]).all()):
        raise AssertionError(f"{label}: non-finite detections")
    if tuple(out["pred_boxes"].shape) != (1, cfg.num_queries, 4):
        raise AssertionError(f"{label}: pred_boxes shape {tuple(out['pred_boxes'].shape)}")
    numbers = {"params_m": n_params / 1e6, "params": n_params, "build_s": build_s, "first_request_ms": request_ms,
               "peak_memory_gib": peak / 2**30, "launches": served[0]}
    log(f"{label} ({preset}, {overrides}): {n_params / 1e6:.2f} M params, built in "
        f"{build_s:.1f} s; first request {request_ms:.1f} ms ({served[0]} msda_forward "
        f"launches), peak {peak / 2**30:.2f} GiB; on {card_line}")
    return numbers, cfg


def phase_architectures(build_model, inference, optim, step, tokenizer_mod, transforms, pc,
                        msda_forward, msda_backward, card_line, profile_dir=None):
    """Phase 10: every architecture switch of the JAX model at full width
    (BERT-base, d = 256, 6 + 6 layers, 900 queries, bf16, 800x1216), from
    seeded weights in the reference's format under `build/phase10`:
    10a GroundingDINO-B served; 10b ZiRa on Swin-B, remat against none;
    10c ResNet-50 with learned positions, ZiRa and `finetune`; 10d Swin-L
    served; 10e the ablation switches; 10f `train_odinw` on Swin-B. With
    `profile_dir`, where a GroundingDINO-B request's time goes. Returns
    {sub-phase: launches} and the numbers."""
    from ziragroundingdino_torch.data import synthetic

    root = pathlib.Path(__file__).resolve().parent / "build" / "phase10"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t0 = time.time()
    model = build_model("groundingdino", device="cpu", seed=0, backbone=SWIN_B)
    torch.save({"model": model.state_dict()}, root / "swinb.pth")
    del model
    synthetic.write_vocab(str(root / "vocab.txt"), tokenizer_mod.make_synthetic_vocab(REQUEST_WORDS))
    synthetic.write_ppm(str(root / "image.ppm"), synthetic_u8())
    (root / "swinb.json").write_text(json.dumps({"model": {"backbone": SWIN_B}}))
    log(f"phase 10: Swin-B checkpoint ({(root / 'swinb.pth').stat().st_size / 2**30:.2f} GiB), "
        f"vocab, image and overrides written in {time.time() - t0:.1f} s")
    launches, numbers = {}, {}
    args = (build_model, inference, optim, step, tokenizer_mod, transforms, pc, msda_forward,
            msda_backward, card_line)
    served = functools.partial(_swin_b_served, profile_dir=profile_dir)
    for name, fn in (("10a", served), ("10b", _swin_b_remat), ("10c", _resnet_learned),
                     ("10d", _swin_l_served), ("10e", _ablations), ("10f", _swin_b_driver)):
        t = time.time()
        launches[name], numbers[name] = fn(root, *args)
        numbers[name]["phase_s"] = time.time() - t
        torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    return launches, numbers


def _swin_b_served(root, build_model, inference, optim, step, tokenizer_mod, transforms, pc,
                   msda_forward, msda_backward, card_line, profile_dir=None):
    """10a: the seeded vanilla Swin-B-384 checkpoint through
    `load_model(..., backbone="swin_B_384_22k")` (no key missing, unexpected
    or mismatched), SWIN_B_REQUESTS `predict` requests (12 launches each),
    the demo with `--config-overrides` (its detections `predict`'s), and
    one Predictor key (batch 1, text bucket 32): one capture of 12
    launches, the replay bitwise equal to the eager forward."""
    from ziragroundingdino_torch.scripts import inference_on_a_image
    from ziragroundingdino_torch.utils.predictor import WARMUP_RUNS, Predictor

    ckpt, vocab, image = (str(root / n) for n in ("swinb.pth", "vocab.txt", "image.ppm"))
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    lm = inference.load_model(ckpt, vocab, preset="groundingdino", dtype="bfloat16",
                              backbone=SWIN_B)
    load_ms = (time.perf_counter() - t) * 1e3
    if lm.missing or lm.unexpected or lm.mismatched:
        raise AssertionError(f"Swin-B load: missing {lm.missing[:5]}, unexpected "
                             f"{lm.unexpected[:5]}, mismatched {lm.mismatched[:5]}")
    cfg = lm.cfg
    if cfg.swin.window_size != 12 or lm.model.backbone[0].out_channels != (256, 512, 1024):
        raise AssertionError(f"not Swin-B 384: {cfg.swin}")
    n_layers = cfg.enc_layers + cfg.dec_layers
    _, (pixels, mask), _ = transforms.load_image(image)
    msda_forward.launches = msda_backward.launches = 0
    request_ms = []
    for i in range(SWIN_B_REQUESTS):
        caption = REQUEST_CAPTIONS[i % len(REQUEST_CAPTIONS)]
        before = msda_forward.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, out = _request_outputs(inference, lm, pixels, mask, caption)
        torch.cuda.synchronize()
        request_ms.append((time.perf_counter() - t) * 1e3)
        if msda_forward.launches - before != n_layers:
            raise AssertionError(f"Swin-B request launched msda_forward "
                                 f"{msda_forward.launches - before} times")
        if not (torch.isfinite(out["pred_logits"]).all()
                and torch.isfinite(out["pred_boxes"]).all()):
            raise AssertionError("Swin-B: non-finite detections")
    served = msda_forward.launches
    peak = torch.cuda.max_memory_allocated()
    stream = (phase_profile(inference, (lm.model, lm, pixels, mask, REQUEST_CAPTIONS),
                            profile_dir, card_line, tag="swin_b")
              if profile_dir is not None else None)
    want = inference.predict(lm, pixels, mask, REQUEST_CAPTIONS[0], box_threshold=0.0)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        pred = inference_on_a_image.main([
            "-c", "groundingdino", "-p", ckpt, "--vocab", vocab, "-i", image, "-t",
            REQUEST_CAPTIONS[0], "-o", str(root / "demo"), "--box-threshold", "0.0",
            "--config-overrides", str(root / "swinb.json")])
    gaps = (float(np.abs(np.asarray(pred["boxes"], np.float32) - want[0]).max()),
            float(np.abs(np.asarray(pred["scores"], np.float32) - want[1]).max()))
    if gaps != (0.0, 0.0) or pred["phrases"] != want[2]:
        raise AssertionError(f"Swin-B demo vs predict: boxes, scores off by {gaps}")

    # one Predictor key: batch 1, PREDICTOR_CLASSES (text bucket 32)
    predictor = Predictor(lm.model, lm.tokenizer)
    counter = _CaptureCount(msda_forward)
    counter.install()
    msda_forward.launches = 0
    ms = []
    try:
        for _ in range(SWIN_B_REQUESTS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            result = predictor([synthetic_u8()], [PREDICTOR_CLASSES], score_threshold=0.0)
            ms.append((time.perf_counter() - t) * 1e3)
    finally:
        counter.restore()
    key = list(predictor._compiled)[-1]
    if (len(predictor._compiled), counter.launches, msda_forward.launches) != (
            1, [n_layers], n_layers * (WARMUP_RUNS + 1)) or key[2] != 32:
        raise AssertionError(f"Swin-B predictor: key {key}, captures {counter.launches}, "
                             f"{msda_forward.launches} launches")
    if not np.isfinite(result[0]["scores"]).all():
        raise AssertionError("Swin-B predictor: non-finite scores")
    replay = _replay_vs_eager(predictor, key, msda_forward)
    if not replay["bitwise"]:
        raise AssertionError(f"Swin-B predictor replay is not the eager forward: {replay}")
    replay_ms = statistics.median(ms[1:])
    numbers = {"load_model_ms": load_ms, "request_ms": request_ms,
               "request_median_ms": statistics.median(request_ms[1:]),
               "img_per_s": 1e3 / statistics.median(request_ms[1:]),
               "first_request_ms": request_ms[0], "peak_memory_gib": peak / 2**30,
               "request_launches": served, "predictor_key": [key[0], list(key[1]), key[2], key[3]],
               "predictor_request_ms": ms, "predictor_replay_median_ms": replay_ms,
               "predictor_img_per_s": 1e3 / replay_ms, "predictor_first_request_ms": ms[0],
               "replay_vs_eager": replay, "stream_ms": stream, "card": card_line}
    log(f"10a Swin-B served: load_model {load_ms:.1f} ms; requests ms "
        f"{[round(x, 2) for x in request_ms]} (first includes warm-up), median "
        f"{numbers['request_median_ms']:.2f} ({numbers['img_per_s']:.2f} img/s), peak "
        f"{peak / 2**30:.2f} GiB, {served} msda_forward launches; demo = predict; predictor "
        f"key {key}: ms {[round(x, 2) for x in ms]}, replay median {replay_ms:.2f} ms "
        f"({1e3 / replay_ms:.2f} img/s), replay bitwise the eager forward; on {card_line}")
    del predictor, lm, out
    return served, numbers


def _swin_b_remat(root, build_model, inference, optim, step, tokenizer_mod, transforms, pc,
                  msda_forward, msda_backward, card_line):
    """10b: the Swin-B checkpoint loaded non-strictly into the ZiRa preset
    three times, remat off, off again and on (`use_checkpoint`,
    `use_transformer_ckpt`), its branches seeded alike; the same first step
    from the same generator seed with dropout on: losses bitwise equal,
    every trainable gradient within REMAT_GRAD_TOL of its scale (the second
    run without remat gives the atomics' floor beside remat's gap), 12
    against 18 `msda_forward` launches and 12 `msda_backward` (6 binned)
    each; the peak and the step time each way. Then phase 7c's steps and
    merge on Swin-B with remat."""
    ckpt, vocab = str(root / "swinb.pth"), str(root / "vocab.txt")
    words = ["person", "dog", "cat", "car"]
    tok = tokenizer_mod.WordPieceTokenizer(tokenizer_mod.make_synthetic_vocab(words))
    pixels, mask = synthetic_image(transforms, pc)
    runs = {}
    for label, remat in (("no_remat", False), ("no_remat_again", False), ("remat", True)):
        lm = inference.load_model(ckpt, vocab, preset="dualzerorepbranchgroundingdino",
                                  dtype="bfloat16", backbone=SWIN_B,
                                  **(REMAT if remat else {}))
        model, cfg = lm.model, lm.cfg
        zira_keys = sorted(k for k in model.state_dict() if "adapter" in k)
        if sorted(lm.missing) != zira_keys or lm.unexpected or lm.mismatched:
            raise AssertionError(f"Swin-B into ZiRa: missing {lm.missing[:5]}, unexpected "
                                 f"{lm.unexpected[:5]}, mismatched {lm.mismatched[:5]}")
        del lm
        _seeded_rep_modules(model)
        optim.set_trainable(model, optim.ZIRA_TRAINABLE_PATTERNS)
        opt = optim.Optimizer(model, pc.OptimizerConfig(), pc.ScheduleConfig())
        tb = tokenizer_mod.tokenize_captions(tok, [" . ".join(words) + " ."],
                                             max_text_len=cfg.max_text_len,
                                             max_categories=cfg.max_categories)
        batch = train_batch(tb, pixels, mask, "cuda", n_labels=len(words))
        gen = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        msda_forward.launches = msda_backward.launches = msda_backward.binned_launches = 0
        matched = matcher_counts()
        t = time.perf_counter()
        total, losses = step.compute_losses(model, batch, gen)
        total.backward()
        grads = {n: p.grad.detach().clone() for n, p in opt.params.items()}
        opt.step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t) * 1e3
        check_matcher(f"10b {label}", matched, 1)
        runs[label] = {
            "losses": {k: v.detach() for k, v in losses.items()}, "grads": grads,
            "launches": (msda_forward.launches, msda_backward.launches,
                         msda_backward.binned_launches),
            "step_ms": step_ms, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "step_peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30}
        want = (_forward_launches(cfg), cfg.enc_layers + cfg.dec_layers, cfg.enc_layers)
        if runs[label]["launches"] != want:
            raise AssertionError(f"Swin-B step, {label}: msda launches "
                                 f"{runs[label]['launches']}, not {want}")
        del model, opt, total, losses, batch
        torch.cuda.empty_cache()
    off, on = runs["no_remat"], runs["remat"]
    gaps = {}  # each pair of steps: the worst gradient gap and its tensor
    for a, b in (("no_remat", "no_remat_again"), ("no_remat", "remat"),
                 ("no_remat_again", "remat")):
        unequal = [k for k in runs[a]["losses"]
                   if not torch.equal(runs[a]["losses"][k], runs[b]["losses"][k])]
        if unequal:
            raise AssertionError(f"Swin-B {a} vs {b}: the losses {unequal} differ")
        err = {n: float((runs[b]["grads"][n] - g).abs().max() / g.abs().max().clamp(min=1e-30))
               for n, g in runs[a]["grads"].items()}
        worst = max(err, key=err.get)
        gaps[f"{a} vs {b}"] = (err[worst], worst)
    log(f"10b ZiRa on Swin-B, one step remat off / off again / on: losses bitwise equal "
        f"({off['losses']['total_loss'].item():.4f}); worst gradient gap of its scale "
        + "; ".join(f"{k} {v[0]:.2e} ({v[1]})" for k, v in gaps.items())
        + f"; msda launches {off['launches']} / {on['launches']}; step ms "
        f"{off['step_ms']:.1f} / {runs['no_remat_again']['step_ms']:.1f} / "
        f"{on['step_ms']:.1f}; peak {off['peak_gib']:.2f} / {on['peak_gib']:.2f} GiB "
        f"({off['step_peak_gib']:.2f} / {on['step_peak_gib']:.2f} above the weights); on "
        f"{card_line}")
    for pair, (gap, name) in gaps.items():
        if gap > REMAT_GRAD_TOL:
            raise AssertionError(f"Swin-B {pair}: gradient of {name} off by {gap}")
    launches, merged = _train_and_merge(
        "swin_b_remat", "dualzerorepbranchgroundingdino", dict(REMAT, backbone=SWIN_B),
        build_model, optim, step, tokenizer_mod, transforms, pc, msda_forward, msda_backward,
        card_line)
    numbers = {k: {"step_ms": r["step_ms"], "peak_memory_gib": r["peak_gib"],
                   "step_peak_gib": r["step_peak_gib"], "launches": r["launches"]}
               for k, r in runs.items()}
    numbers.update(losses_bitwise_equal=True, worst_grad_rel_gap={k: v[0] for k, v in gaps.items()},
                   steps_and_merge=merged, card=card_line)
    return {"first_step": (off["launches"], on["launches"]), "steps": launches}, numbers


def _resnet_learned(root, build_model, inference, optim, step, tokenizer_mod, transforms, pc,
                    msda_forward, msda_backward, card_line):
    """10c: `dualzerorepbranchgroundingdino` on ResNet-50 with learned
    positions: one request, then phase 7c's steps and merge; then one
    `finetune` step on the same backbone (its zero-init heads and
    deformable kernels seeded) in which the frozen BN's four tensors and
    the learned tables get a gradient that is not all zero and move, as
    they do in JAX."""
    overrides = {"backbone": "resnet50", "position_embedding": "learned"}
    served, _ = _serve_once("10c resnet50 learned", "dualzerorepbranchgroundingdino", overrides,
                            build_model, inference, tokenizer_mod, transforms, pc, msda_forward,
                            msda_backward, card_line, seed_rep=True)
    torch.cuda.empty_cache()
    launches, trained = _train_and_merge(
        "resnet50_learned", "dualzerorepbranchgroundingdino", overrides, build_model, optim,
        step, tokenizer_mod, transforms, pc, msda_forward, msda_backward, card_line)
    torch.cuda.empty_cache()

    model = build_model("finetune", device="cuda", dtype="bfloat16", seed=0, **overrides)
    cfg = model.cfg
    _seeded_pet_modules(model)
    _seeded_deformable(model)
    optim.set_trainable(model, optim.trainable_patterns_for_cfg(cfg), freeze_all=cfg.freeze_all)
    opt = optim.Optimizer(model, pc.OptimizerConfig(), pc.ScheduleConfig())
    # the 53 frozen BNs' four tensors (the stem's, 3 a block, 4 downsamples)
    # and the two learned tables
    watched = [n for n in opt.params if n.startswith("backbone.1.") or (
        n.startswith("backbone.0.body.") and "conv" not in n and "downsample.0" not in n)]
    n_bn = sum(n.endswith(FROZEN_BN) for n in watched)
    if (len(watched), n_bn) != (4 * 53 + 2, 2 * 53) or len(opt.params) != len(
            list(model.parameters())):
        raise AssertionError(f"finetune on ResNet trains {len(opt.params)} tensors, "
                             f"{len(watched)} BN and table tensors")
    start = {n: opt.params[n].detach().clone() for n in watched}
    ungraded = record_gradients(opt)
    words = ["person", "dog", "cat", "car"]
    tok = tokenizer_mod.WordPieceTokenizer(tokenizer_mod.make_synthetic_vocab(words))
    tb = tokenizer_mod.tokenize_captions(tok, [" . ".join(words) + " ."],
                                         max_text_len=cfg.max_text_len,
                                         max_categories=cfg.max_categories)
    pixels, mask = synthetic_image(transforms, pc)
    batch = train_batch(tb, pixels, mask, "cuda", n_labels=len(words))
    msda_forward.launches = msda_backward.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    metrics = step.train_step(model, opt, batch, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    ft_ms = (time.perf_counter() - t) * 1e3
    no_grad = set(ungraded())
    still = [n for n in watched if torch.equal(opt.params[n].detach(), start[n])]
    missed = [n for n in watched if n in no_grad]
    log(f"10c finetune on ResNet-50 + learned positions: one step {ft_ms:.1f} ms, loss "
        f"{metrics['total_loss'].item():.4f}, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {len(watched)} BN and table "
        f"tensors watched, {len(missed)} without a gradient, {len(still)} unmoved; msda "
        f"launches ({msda_forward.launches}, {msda_backward.launches}); on {card_line}")
    if missed or still or not torch.isfinite(metrics["total_loss"]):
        raise AssertionError(f"finetune on ResNet: no gradient {missed[:5]}, unmoved {still[:5]}")
    numbers = {"request": served, "steps_and_merge": trained, "finetune_step_ms": ft_ms,
               "finetune_watched_tensors": len(watched), "card": card_line}
    return {"request": served["launches"], "steps": launches,
            "finetune": (msda_forward.launches, msda_backward.launches)}, numbers


def _swin_l_served(root, build_model, inference, optim, step, tokenizer_mod, transforms, pc,
                   msda_forward, msda_backward, card_line):
    """10d: the vanilla model on Swin-L 384 (window 12): one request."""
    numbers, _ = _serve_once("10d Swin-L", "groundingdino", {"backbone": SWIN_L}, build_model,
                             inference, tokenizer_mod, transforms, pc, msda_forward,
                             msda_backward, card_line)
    numbers["card"] = card_line
    return numbers["launches"], numbers


def _ablations(root, build_model, inference, optim, step, tokenizer_mod, transforms, pc,
               msda_forward, msda_backward, card_line):
    """10e: one request each with a switch of ABLATIONS off; the parameter
    count drops by exactly the parameters that the switch removes (counted
    on the model with the switch on, built on the meta device)."""
    from ziragroundingdino_torch.models.groundingdino import GroundingDINO

    launches, numbers = {}, {"card": card_line}
    for switch, parts in ABLATIONS:
        n, cfg = _serve_once(f"10e {switch}=False", "dualzerorepbranchgroundingdino",
                             {switch: False}, build_model, inference, tokenizer_mod,
                             transforms, pc, msda_forward, msda_backward, card_line,
                             seed_rep=True)
        with torch.device("meta"):
            full = dict(GroundingDINO(cfg.replace(**{switch: True})).named_parameters())
        fewer = sum(p.numel() for p in full.values()) - n["params"]
        removed = sum(p.numel() for k, p in full.items() if any(s in k for s in parts))
        if fewer != removed or (parts and not removed):
            raise AssertionError(f"{switch}=False: {fewer} parameters fewer, not {removed}")
        n["params_removed_m"] = removed / 1e6
        launches[switch], numbers[switch] = n["launches"], n
        torch.cuda.empty_cache()
    return launches, numbers


def _swin_b_driver(root, build_model, inference, optim, step, tokenizer_mod, transforms, pc,
                   msda_forward, msda_backward, card_line):
    """10f: `scripts/train_odinw.main --config-overrides` (Swin-B) from the
    vanilla Swin-B checkpoint on phase 6's synthetic tasks, PET_ITERS steps
    a task, remat on by default: 18 `msda_forward` launches a step and 12
    an eval batch, 12 `msda_backward` a step; only ZiRa tensors change; a
    finite report."""
    from ziragroundingdino_torch.data import synthetic
    from ziragroundingdino_torch.scripts import train_odinw

    classes = [c for name in PET_TASKS for c in LIFECYCLE_TASKS[name][0]]
    synthetic.write_vocab(str(root / "tasks_vocab.txt"),
                          tokenizer_mod.make_synthetic_vocab(classes))
    for i, name in enumerate(PET_TASKS):
        cls, n_train, n_test = LIFECYCLE_TASKS[name]
        synthetic.write_odinw_task(str(root / "data"), name, cls, n_train, n_test,
                                   LIFECYCLE_ORIG, seed=100 + 10 * i)
    out = root / "out"
    args = ["--checkpoint", str(root / "swinb.pth"), "--vocab", str(root / "tasks_vocab.txt"),
            "--datasets-root", str(root / "data"), "--tasks", ",".join(PET_TASKS),
            "--output-dir", str(out), "--batch-size", str(PET_BATCH),
            "--max-iter", str(PET_ITERS), "--checkpoint-period", str(PET_ITERS),
            "--config-overrides", str(root / "swinb.json")]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    msda_forward.launches = msda_backward.launches = msda_backward.binned_launches = 0
    matched = matcher_counts()
    loaded, load_model = [], inference.load_model

    def recording(*a, **kw):  # the config that train_odinw built
        lm = load_model(*a, **kw)
        loaded.append(lm.cfg)
        return lm

    inference.load_model = recording
    t = time.perf_counter()
    try:
        report = train_odinw.main(args)
    finally:
        inference.load_model = load_model
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    launches = (msda_forward.launches, msda_backward.launches, msda_backward.binned_launches)
    check_matcher("phase 10f", matched, PET_ITERS * len(PET_TASKS))
    peak = torch.cuda.max_memory_allocated()
    steps = PET_ITERS * len(PET_TASKS)
    batches = sum(-(-LIFECYCLE_TASKS[n][2] // PET_BATCH) for n in PET_TASKS)
    cfg = loaded[0]
    if (cfg.backbone, cfg.swin.window_size, cfg.use_checkpoint, cfg.use_transformer_ckpt) != (
            SWIN_B, 12, True, True):
        raise AssertionError(f"train_odinw built {cfg.backbone}, window {cfg.swin.window_size}, "
                             f"remat {cfg.use_checkpoint, cfg.use_transformer_ckpt}")
    n_layers = cfg.enc_layers + cfg.dec_layers
    want = (n_layers * batches + _forward_launches(cfg) * steps, n_layers * steps,
            cfg.enc_layers * steps)
    log(f"10f train_odinw on Swin-B in {run_s:.1f} s ({steps} steps, {batches} eval batches): "
        f"msda launches {launches}; report {report}; peak {peak / 2**30:.2f} GiB; on {card_line}")
    if launches != want:
        raise AssertionError(f"Swin-B driver: msda launches {launches}, not {want}")
    keys = {f"AP/{n}" for n in PET_TASKS} | {"avg_AP"}
    if set(report) != keys or not all(np.isfinite(v) for v in report.values()):
        raise AssertionError(f"Swin-B driver report {report}")
    before = torch.load(root / "swinb.pth", map_location="cpu", weights_only=True)["model"]
    for name in PET_TASKS:
        params = torch.load(out / name / "state_final.pt", map_location="cpu",
                            weights_only=True)["params"]
        changed = [k for k, v in params.items()
                   if "adapter" not in k and not torch.equal(v, before[k])]
        if changed or not any("adapter" in k for k in params):
            raise AssertionError(f"Swin-B driver, task {name}: changed {changed[:5]}")
        before = params
    return launches, {"run_s": run_s, "peak_memory_gib": peak / 2**30, "report": report,
                      "card": card_line}


# ---------------------------------------------------------------------------
# 11. data parallelism: train_odinw --mesh over NCCL, two ranks sharing the
#     card over gloo, gradient accumulation
# ---------------------------------------------------------------------------

DP_ITERS = 2  # 11a: steps a task, at phase 6's batch (2)
DP_TOL = 1e-2  # 11b/11c: batch 1 against batch 2 (relative, or of each tensor's scale)
# 11b/11c run in f32: the random weights' bf16 encoder scores hold exact
# ties, and which tied queries the top-900 selection keeps depends on the
# batch's size, so a bf16 image at batch 1 meets other decoder queries than
# at batch 2 (aux box losses 10-20% apart on an H100)
DP_DTYPE = "float32"
DP_PRESETS = ("dualzerorepbranchgroundingdino", "repconvbngroundingdino")
# 11b's halves differ wherever the step reduces over the global batch: two
# unrelated images, captions of 4 and 2 categories (masked ZIL means over
# other numbers of valid tokens) and 5 and 2 valid targets (`num_boxes`)
DP_CAPTIONS = (("person", "dog", "cat", "car"), ("bicycle", "zebra"))
DP_TARGETS = (5, 2)
# 11b's steps with each rank replaying the batch-2 run's chosen queries and
# assignments: losses, and gradients of their scale (ten times and six times
# the largest of an H100's readings, 6.3e-7 and 1.6e-4: f32 rounding, the
# unordered atomics of `msda_backward`); left to choose for itself, a rank may
# order two near-tied queries of the top 900 otherwise than batch 2 does,
# which moves the decoder's class losses by ~5e-4 (DP_TOL holds those steps)
DP_PINNED_TOL = (1e-5, 1e-3)
# 11b: the BatchNorm statistics and the ZeroConvBN outputs, relative to their
# scale, before any query is chosen (read: 2.4e-7 and 1.9e-7 on an H100)
DP_STATS_TOL = 1e-5
DP_TOP = 100  # 11a/11b: the reference's most confident detections a run must also hold
DP_LAUNCHES = (18, 12, 1)  # msda_forward (remat), msda_backward, lsap launches a train step
DP_CARD = "cuda:0"  # the card of every phase 11 process (11b's two ranks share it)
WORKER = pathlib.Path(__file__).resolve()  # the script `run_ranks` starts


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(kind: str, n: int, root: pathlib.Path, timeout: int = 900) -> float:
    """This script's phase 11 worker `kind` in n processes started by
    `torch.distributed.run` (its own process group; this process joins
    none); returns the launch's wall seconds, raises if a rank failed."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(n),
           "--master_addr", "127.0.0.1", "--master_port", str(_free_port()),
           str(WORKER), "--phase11-worker", kind,
           "--phase11-root", str(root)]
    t = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    (root / f"worker_{kind}.log").write_text(res.stdout + res.stderr)
    if res.returncode:
        tail = "\n".join((res.stdout + res.stderr).splitlines()[-60:])
        raise AssertionError(f"phase 11 worker {kind} on {n} ranks exited {res.returncode}:\n"
                             f"{tail}")
    return time.perf_counter() - t


class _StepProbe:
    """Around the trainer's `train_step` and the evaluator's inference: per
    step its ms (synchronised) and its `msda_forward` / `msda_backward` /
    `lsap` launches; the first step's losses and the trainable gradients
    its backward left; one step's NCCL kernel launches under torch.profiler
    (`profile_at`) and DDP's bucket count; each eval batch's image ids and
    detections; with `replicas`, each step's `_replicas` digests after the
    update."""

    def __init__(self, profile_at=None, replicas=False):
        from ziragroundingdino_torch.eval import evaluator
        from ziragroundingdino_torch.ops.lsap import lsap_cuda
        from ziragroundingdino_torch.ops.msda_cuda import msda_backward, msda_forward
        from ziragroundingdino_torch.train import trainer as trainer_mod

        self.trainer_mod, self.evaluator = trainer_mod, evaluator
        self.counters = (msda_forward, msda_backward, lsap_cuda)
        self.profile_at = profile_at
        self.ms, self.launches, self.evals = [], [], []
        self.replicas = [] if replicas else None
        self.losses = self.grads = self.nccl = self.buckets = self.nccl_kernels_traced = None
        self.saved = []

    def _launched(self):
        return tuple(c.launches for c in self.counters)

    def step(self, model, optimizer, batch, generator=None, **kw):
        from torch.nn.parallel import DistributedDataParallel
        from torch.profiler import ProfilerActivity, profile

        i = len(self.ms)
        if i == 0:
            def capture():
                self.grads = {n: p.grad.detach().float().cpu()
                              for n, p in optimizer.params.items() if p.grad is not None}
                return type(optimizer).step(optimizer)
            optimizer.step = capture
        prof = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                if i == self.profile_at else contextlib.nullcontext())
        before = self._launched()
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            with prof as p:
                metrics = self.orig_step(model, optimizer, batch, generator, **kw)
                torch.cuda.synchronize()
        finally:
            if i == 0:
                del optimizer.step
        self.ms.append((time.perf_counter() - t) * 1e3)
        self.launches.append(tuple(a - b for a, b in zip(self._launched(), before)))
        if i == 0:
            self.losses = {k: v.detach().float().cpu() for k, v in metrics.items()
                           if k != "grad_norm"}
        if self.replicas is not None:
            self.replicas.append(_replicas(optimizer.params))
        if p is not None:
            from torch.autograd import DeviceType

            # the collectives' calls on the host (one NCCL kernel each), and
            # the NCCL kernels that the trace shows on the card
            self.nccl = sum(1 for e in p.events() if e.device_type == DeviceType.CPU
                            and e.name == "nccl:all_reduce")
            self.nccl_kernels_traced = sum(1 for e in p.events()
                                           if e.device_type == DeviceType.CUDA
                                           and "nccl" in e.name.lower())
            if isinstance(model, DistributedDataParallel):
                self.buckets = len(model._get_ddp_logging_data()["bucket_sizes"].split(","))
        return metrics

    def make_inference_fn(self, *a, **k):
        fn = self.orig_make(*a, **k)

        def recorded(batch):
            det = fn(batch)
            self.evals.append((np.asarray(batch["image_ids"]).tolist(),
                               {n: v.float().cpu() for n, v in det.items()}))
            return det
        return recorded

    def install(self):
        self.orig_step = self.trainer_mod.train_step
        self.orig_make = self.evaluator.make_inference_fn
        self.trainer_mod.train_step = self.step
        self.evaluator.make_inference_fn = self.make_inference_fn
        return self

    def restore(self):
        self.trainer_mod.train_step = self.orig_step
        self.evaluator.make_inference_fn = self.orig_make

    def record(self) -> dict:
        return {"ms": self.ms, "launches": self.launches, "evals": self.evals,
                "losses": self.losses, "grads": self.grads, "nccl": self.nccl,
                "nccl_kernels_traced": self.nccl_kernels_traced, "buckets": self.buckets,
                "replicas": self.replicas}


def _images(evals):
    """The eval's images in the global order from each rank's (image ids,
    detections) per batch (`evals`, one list per rank): batch by batch,
    rank by rank, without the padded copies (a copy repeats an image of its
    global batch)."""
    rows = []
    for batches in zip(*evals):
        seen = set()
        for ids, det in batches:
            for j, i in enumerate(ids):
                if i not in seen:
                    seen.add(i)
                    rows.append((i, {k: v[j] for k, v in det.items()}))
    return rows


def _same_detections(label, got, want, size: float, tol=DP_TOL) -> dict:
    """Each image's detections against the reference's: the same images in
    the same order, the same count, and (unless `tol` is None) the sorted
    scores within `tol` and every one of the reference's DP_TOP most
    confident detections found in `got` with its label and its box within
    `tol` of the image's size (an order-free match: near-ties of bf16
    scores may swap neighbours). Returns the errors."""
    if [i for i, _ in got] != [i for i, _ in want]:
        raise AssertionError(f"{label}: image order {[i for i, _ in got]} against "
                             f"{[i for i, _ in want]}")
    score_err = box_err = 0.0
    for (_, g), (_, w) in zip(got, want):
        if len(g["scores"]) != len(w["scores"]):
            raise AssertionError(f"{label}: {len(g['scores'])} detections, not {len(w['scores'])}")
        score_err = max(score_err, float((g["scores"].sort(descending=True).values
                                          - w["scores"].sort(descending=True).values).abs().max()))
        for j in w["scores"].argsort(descending=True)[:DP_TOP].tolist():
            same = g["labels"] == w["labels"][j]
            d = (g["boxes"][same] - w["boxes"][j]).abs().amax(-1) / size
            box_err = max(box_err, float(d.min()) if len(d) else float("inf"))
    if tol is not None and (score_err > tol or box_err > tol):
        raise AssertionError(f"{label}: scores off by {score_err}, boxes by {box_err} of the "
                             f"image size")
    return {"images": len(got), "score_max_abs_err": score_err, "box_max_err_of_size": box_err}


def _grad_errors(got: dict, want: dict) -> dict:
    """Each gradient's error against its own scale, by name; a
    conv bias that a batch-statistics BatchNorm follows (repconvbn's
    `branch.conv.bias`, whose gradient is 0 in exact arithmetic, so both
    sides hold rounding) against its conv weight's."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"gradients of {sorted(set(got) ^ set(want))} on one side only")

    def scale(n):
        if n.endswith("branch.conv.bias"):
            n = n[:-len("bias")] + "weight"
        return max(float(want[n].abs().max()), 1e-30)

    return {n: float((got[n] - want[n]).abs().max()) / scale(n) for n in want}


def _worst(errors: dict, k: int = 3) -> dict:
    """The k largest of {name: error}."""
    return dict(sorted(errors.items(), key=lambda kv: -kv[1])[:k])


def _dp_inputs(pc, tokenizer_mod, transforms, device, captions=DP_CAPTIONS,
               targets=DP_TARGETS):
    """A global batch of 2: phase 5b's 800x1199 image and an unrelated seeded
    640x960 one, padded to one bucket, a caption each (`captions`, lists of
    category words) and `targets` valid seeded boxes each, their labels
    below the smaller caption's category count."""
    words = sorted({w for c in captions for w in c})
    tok = tokenizer_mod.WordPieceTokenizer(tokenizer_mod.make_synthetic_vocab(words))
    cfg = pc.get_model_config(DP_PRESETS[0])
    tb = tokenizer_mod.tokenize_captions(tok, [" . ".join(c) + " ." for c in captions],
                                         max_text_len=cfg.max_text_len,
                                         max_categories=cfg.max_categories)
    data_cfg = pc.DataConfig()
    bucket = transforms.pick_bucket(800, 1199, data_cfg.shape_buckets)
    padded = [transforms.pad_to_bucket(transforms.normalize(image, data_cfg), bucket)
              for image in (synthetic_u8(), np.random.RandomState(1).randint(
                  0, 256, (640, 960, 3)).astype(np.uint8))]
    batch = train_batch(tb, np.stack([p for p, _ in padded]), np.stack([m for _, m in padded]),
                        device, n_boxes=max(targets), n_labels=min(len(c) for c in captions))
    batch["gt_valid"] = (torch.arange(max(targets), device=device)
                         < torch.tensor(targets, device=device)[:, None])
    return batch


def _dp_model(build_model, optim, preset: str, device, dtype: str = DP_DTYPE, **overrides):
    """A preset at full width in DP_DTYPE, seed 0, its ZiRa branches seeded; for
    the repconvbn preset every ZeroConvBN made to keep its batch's
    statistics as its running ones (momentum 0, `update_stats`), so that
    they can be read after a step."""
    from ziragroundingdino_torch.models import zira

    model = build_model(preset, device="cpu", dtype=dtype, seed=0, **overrides)
    _seeded_rep_modules(model)
    model.to(device)
    for m in model.modules():
        if isinstance(m, zira.ZeroConvBN):
            m.momentum = 0.0
            m.forward_train = functools.partial(zira.ZeroConvBN.forward_train, m,
                                                update_stats=True)
    optim.set_trainable(model, optim.trainable_patterns_for_cfg(model.cfg),
                        freeze_all=model.cfg.freeze_all)
    return model


class _GradKeeper:
    """An optimizer for `train_step` that keeps the gradients it is given."""

    def __init__(self, model):
        self.params = {n: p for n, p in model.named_parameters() if p.requires_grad}
        self.grads = None

    def will_update(self):
        return True

    def step(self):
        self.grads = {n: p.grad.detach().float().cpu() for n, p in self.params.items()
                      if p.grad is not None}
        for p in self.params.values():
            p.grad = None
        return torch.zeros(())


def _bn_stats(model) -> dict:
    from ziragroundingdino_torch.models import zira

    return {f"{n}.{k}": getattr(m.branch.bn, k).detach().float().cpu()
            for n, m in model.named_modules() if isinstance(m, zira.ZeroConvBN)
            for k in ("running_mean", "running_var")}


def _local_num_boxes_err(local: list, total: float) -> float:
    """How far from the batch-2 total loss `total` the ranks' mean would be
    if each rank divided its class and box sums by its own count of
    targets (DP_TARGETS) in place of the global batch's share: from each
    rank's own losses (`local`), whose set-criterion terms the global
    divisor divided."""
    from ziragroundingdino_torch.train.criterion import weighted_total

    share = sum(DP_TARGETS) / len(DP_TARGETS)
    mean = statistics.mean(
        own["total_loss"] + (share / n - 1) * weighted_total(
            {k: v for k, v in own.items() if k.startswith(("loss_class", "loss_bbox",
                                                            "loss_giou"))})
        for own, n in zip(local, DP_TARGETS))
    return abs(mean - total) / abs(total)


def _dp_step(build_model, optim, step, preset, batch, device, rank=None, pinned=None):
    """One step of `preset` on `batch` (this rank's half under DDP when
    `rank` is given): its global losses and this rank's own (`local`), the
    trainable gradients, the BatchNorm statistics, the ZeroConvBN outputs,
    the encoder positions chosen as the decoder's queries (`topk_idx`) and
    the assignments the criterion used (`assignments`, the 7 outputs' rows
    stacked output by output). The run chooses its queries and matches its
    own outputs, or with `pinned` (the one-process run's record) replays
    its image's rows of both."""
    from ziragroundingdino_torch.models import transformer, zira
    from ziragroundingdino_torch.train import criterion

    model = _dp_model(build_model, optim, preset, device)
    keeper = _GradKeeper(model)
    net = model
    if rank is not None:
        batch = {k: v[rank:rank + 1] for k, v in batch.items()}
        net = step.wrap_ddp(model)
    conv_out, chosen, used, local, hs = [], [], [], {}, []
    model.transformer.decoder.register_forward_hook(
        lambda m, i, o: hs.append(o[0][-1].detach().float().cpu()))
    for m in model.modules():
        if isinstance(m, zira.ZeroConvBN):
            def recorded(x, fwd=m.forward_train):
                out, zil = fwd(x)
                conv_out.append(out.detach().float().cpu())
                return out, zil
            m.forward_train = recorded
    select_topk, match_batch = transformer.select_topk, criterion.match_batch
    mean_over_ranks = step.dist.mean_over_ranks

    def selected(scores, k):
        chosen.append(select_topk(scores, k) if pinned is None
                      else pinned["topk_idx"][rank:rank + 1].to(device))
        return chosen[-1]

    def matched(*a, **k):
        used.append(match_batch(*a, **k) if pinned is None
                    else pinned["assignments"][rank::2].to(device))
        return used[-1]

    def kept(losses):
        local.update({k: float(v) for k, v in losses.items()})
        return mean_over_ranks(losses)

    transformer.select_topk, criterion.match_batch = selected, matched
    step.dist.mean_over_ranks = kept
    try:
        metrics = step.train_step(net, keeper, batch)
    finally:
        transformer.select_topk, criterion.match_batch = select_topk, match_batch
        step.dist.mean_over_ranks = mean_over_ranks
    losses = {k: float(v) for k, v in metrics.items() if k != "grad_norm"}
    out = {"losses": losses, "local": local or losses, "grads": keeper.grads,
           "bn": _bn_stats(model), "conv_out": conv_out, "topk_idx": chosen[0].cpu(),
           "hs_last": hs[0],
           "assignments": used[0].cpu()}
    del net, model
    torch.cuda.empty_cache()
    return out


DP_ROUNDS, DP_STEPS = 4, 3  # 11a's timing: rounds of steps each way, the order alternating


def _ddp_overhead(build_model, optim, step, pc, tokenizer_mod, transforms) -> dict:
    """ZiRa train steps as `train_odinw` takes them (bf16, remat, dropout on) at
    11b's batch of 2, with the DDP wrapper and without it on the same model
    in turns (DDP, plain, plain, DDP, ...), on one rank, after one step
    each: what the wrapper costs before a second card shares the work."""
    model = _dp_model(build_model, optim, DP_PRESETS[0], DP_CARD, dtype="bfloat16", **REMAT)
    opt = optim.Optimizer(model, pc.OptimizerConfig(), pc.ScheduleConfig())
    batch = _dp_inputs(pc, tokenizer_mod, transforms, DP_CARD)
    nets = {"ddp": step.wrap_ddp(model), "plain": model}
    gen = torch.Generator(device=DP_CARD).manual_seed(0)
    for net in nets.values():
        step.train_step(net, opt, batch, gen)
    ms = {"ddp": [], "plain": []}
    for r in range(DP_ROUNDS):
        for mode in (("ddp", "plain") if r % 2 == 0 else ("plain", "ddp")):
            for _ in range(DP_STEPS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                step.train_step(nets[mode], opt, batch, gen)
                torch.cuda.synchronize()
                ms[mode].append((time.perf_counter() - t) * 1e3)
    del nets, model, opt
    torch.cuda.empty_cache()
    return {"step_ms": ms, "median_ms": {k: statistics.median(v) for k, v in ms.items()}}


def phase11_worker(kind: str, root: pathlib.Path) -> None:
    """A rank of phase 11, started by `run_ranks`: "a", `train_odinw --mesh
    1` over NCCL with `_StepProbe` (the second step profiled), then
    `_ddp_overhead`; "b", two
    ranks on one card over gloo: `_dp_step` of each DP_PRESETS preset on
    its half of the batch, then `eval_coco --mesh 2`. Writes its record to
    `root/<kind>_rank<r>.pt`."""
    import os

    from ziragroundingdino_torch import config as pc
    from ziragroundingdino_torch.data import transforms
    from ziragroundingdino_torch.models import build_model
    from ziragroundingdino_torch.parallel import dist
    from ziragroundingdino_torch.scripts import eval_coco, train_odinw
    from ziragroundingdino_torch.text import tokenizer as tokenizer_mod
    from ziragroundingdino_torch.train import optim, step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ["RANK"])
    spec = json.loads((root / "spec.json").read_text())
    out = {}
    if kind == "a":
        dist.init_from_env(DP_CARD)  # NCCL on the card; `train_odinw` keeps the group
        probe = _StepProbe(profile_at=1).install()
        torch.cuda.reset_peak_memory_stats()
        try:
            t = time.perf_counter()
            out["report"] = train_odinw.main(spec["train_args"] + ["--mesh", "1"])
            out["run_s"] = time.perf_counter() - t
        finally:
            probe.restore()
        out.update(probe.record(), peak=torch.cuda.max_memory_allocated())
        out["overhead"] = _ddp_overhead(build_model, optim, step, pc, tokenizer_mod, transforms)
        dist.destroy()
    else:
        dist.init_from_env(DP_CARD, "gloo")
        x = torch.full((3,), float(rank + 1), device=DP_CARD)
        y = dist.all_reduce_sum(x)
        if y.tolist() != [3.0] * 3:
            raise AssertionError(f"gloo all-reduce of card tensors on rank {rank}: {y.tolist()}")
        batch = _dp_inputs(pc, tokenizer_mod, transforms, DP_CARD)
        for preset in DP_PRESETS:
            pinned = torch.load(root / f"pinned_{preset}.pt")
            out[preset] = {"own": _dp_step(build_model, optim, step, preset, batch, DP_CARD,
                                           rank),
                           "pinned": _dp_step(build_model, optim, step, preset, batch, DP_CARD,
                                              rank, pinned)}
        probe = _StepProbe().install()
        try:
            out["eval"] = eval_coco.main(spec["eval_args"] + [
                "--mesh", "2", "--device", DP_CARD])
        finally:
            probe.restore()
        out["evals"] = probe.evals
        dist.destroy()
    torch.save(out, root / f"{kind}_rank{rank}.pt")


def phase_data_parallel(build_model, optim, step, tokenizer_mod, transforms, pc,
                        msda_forward, msda_backward, card_line):
    """11a: `train_odinw --mesh 1` under `torch.distributed.run` (NCCL, one
    rank) on phase 6's seeded checkpoint and tasks, DP_ITERS steps a task,
    against the plain run in this process: the first step's losses
    bitwise, every trainable gradient within REMAT_GRAD_TOL of its scale,
    the eval's images in the same order with as many detections each;
    DP_LAUNCHES a step either way.
    11b: two ranks on the card over gloo: DDP steps of each DP_PRESETS
    preset on `_dp_inputs`' halves against this process at batch 2, the
    ranks choosing queries and matching for themselves (losses and
    gradients within DP_TOL) and replaying batch 2's (DP_PINNED_TOL), the
    repconvbn statistics and ZeroConvBN outputs within DP_STATS_TOL, and a
    local `num_boxes` shown to miss (11b and 11c in DP_DTYPE); then
    `eval_coco --mesh 2` on task A's 3 test images (the last batch padded)
    against `eval_coco`. 11c: `batch_size_scale=2` over two halves of equal
    counts against one step at batch 2: AdamW and the schedule step once,
    the EMA twice, the trainable tensors after the update within DP_TOL of
    their scale, one `lsap` launch a call."""
    from ziragroundingdino_torch.ops.lsap import lsap_cuda
    from ziragroundingdino_torch.scripts import eval_coco, train_odinw

    root = pathlib.Path(__file__).resolve().parent / "build" / "phase11"
    t0 = time.time()
    write_lifecycle_inputs(build_model, root)
    task = next(iter(LIFECYCLE_TASKS))
    split = root / "data" / task / "test"
    overrides = json.loads((root / "overrides.json").read_text())
    overrides["model"]["compute_dtype"] = DP_DTYPE
    (root / "overrides_eval.json").write_text(json.dumps(overrides))
    eval_args = ["--checkpoint", str(root / "ckpt.pth"), "--vocab", str(root / "vocab.txt"),
                 "--json", str(split / "annotations_without_background.json"),
                 "--image-root", str(split), "--batch-size", str(LIFECYCLE_BATCH),
                 "--config-overrides", str(root / "overrides_eval.json")]
    (root / "spec.json").write_text(json.dumps({
        "train_args": lifecycle_args(root, root / "mesh1", DP_ITERS, DP_ITERS, 0),
        "eval_args": eval_args}))
    result = {"card": card_line}

    # 11a: the plain run here, then --mesh 1 over NCCL
    probe = _StepProbe().install()
    try:
        t = time.perf_counter()
        train_odinw.main(lifecycle_args(root, root / "plain", DP_ITERS, DP_ITERS, 0))
        plain_s = time.perf_counter() - t
    finally:
        probe.restore()
    plain = probe.record()
    launch_s = run_ranks("a", 1, root)
    mesh = torch.load(root / "a_rank0.pt", weights_only=False)
    bitwise = {k: bool(torch.equal(mesh["losses"][k], v)) for k, v in plain["losses"].items()}
    grad_err = max(_grad_errors(mesh["grads"], plain["grads"]).values())
    steps = DP_ITERS * len(LIFECYCLE_TASKS)
    for label, rec in (("plain", plain), ("--mesh 1", mesh)):
        if rec["launches"] != [DP_LAUNCHES] * steps:
            raise AssertionError(f"11a {label}: launches a step {rec['launches']}, not "
                                 f"{DP_LAUNCHES} x {steps}")
    if sorted(mesh["losses"]) != sorted(plain["losses"]) or not all(bitwise.values()):
        raise AssertionError(f"11a: first step's losses not bitwise equal: {bitwise}")
    if grad_err > REMAT_GRAD_TOL:
        raise AssertionError(f"11a: first step's gradients off by {grad_err} of their scale")
    # the two runs' weights part after the first step (msda_backward's
    # unordered atomics, then AdamW's normalised steps), so only the images'
    # order and count are held here; 11b compares detections of equal weights
    size = float(max(LIFECYCLE_ORIG))
    evals = _same_detections("11a eval", _images([mesh["evals"]]), _images([plain["evals"]]),
                             size, tol=None)
    result["11a"] = {
        "first_step_losses_bitwise": all(bitwise.values()),
        "first_step_grad_max_rel_err": grad_err,
        "step_ms_ddp": mesh["ms"], "step_ms_plain": plain["ms"],
        "run_step_median_ms": {"ddp": statistics.median(mesh["ms"]),
                                  "plain": statistics.median(plain["ms"])},
        "nccl_all_reduce_calls_per_step": mesh["nccl"], "ddp_buckets": mesh["buckets"],
        "nccl_kernels_in_the_trace": mesh["nccl_kernels_traced"],
        "ddp_overhead": mesh["overhead"],
        "launches_per_step": {name: [n[i] for n in mesh["launches"]] for i, name in
                              enumerate(("msda_forward", "msda_backward", "lsap"))},
        "peak_gib": mesh["peak"] / 2**30, "eval": evals, "run_s": mesh["run_s"],
        "plain_run_s": plain_s, "launch_s": launch_s}
    log("11a: " + json.dumps(result["11a"]))
    if not mesh["buckets"] or mesh["nccl"] < mesh["buckets"]:
        raise AssertionError(f"11a: {mesh['nccl']} NCCL all-reduces in a step, "
                             f"{mesh['buckets']} DDP buckets")
    torch.cuda.empty_cache()

    # 11b: this process at batch 2, then two ranks on the card over gloo
    batch = _dp_inputs(pc, tokenizer_mod, transforms, DP_CARD)
    ref = {p: _dp_step(build_model, optim, step, p, batch, DP_CARD) for p in DP_PRESETS}
    for p in DP_PRESETS:
        torch.save({k: ref[p][k] for k in ("topk_idx", "assignments")}, root / f"pinned_{p}.pt")
    probe = _StepProbe().install()
    try:
        ref_eval = eval_coco.main(eval_args + ["--device", DP_CARD])
    finally:
        probe.restore()
    ref_images = _images([probe.evals])
    launch_s = run_ranks("b", 2, root)
    ranks = [torch.load(root / f"b_rank{r}.pt", weights_only=False) for r in range(2)]
    result["11b"] = {"launch_s": launch_s}
    failed = []
    for preset in DP_PRESETS:
        want = ref[preset]
        if (preset == "repconvbngroundingdino") != bool(want["bn"]):
            raise AssertionError(f"11b {preset}: BatchNorm statistics {sorted(want['bn'])}")
        for how, (loss_tol, grad_tol) in (("own", (DP_TOL, DP_TOL)), ("pinned", DP_PINNED_TOL)):
            got = ranks[0][preset][how]
            halves = [(i, r[preset][how]) for i, r in enumerate(ranks)]
            if ranks[1][preset][how]["losses"] != got["losses"]:
                raise AssertionError(f"11b {preset} {how}: the ranks' losses differ")
            if sorted(got["losses"]) != sorted(want["losses"]):
                raise AssertionError(f"11b {preset} {how}: losses {sorted(got['losses'])}")
            errs = {k: abs(got["losses"][k] - v) / max(abs(v), 1e-30)
                    for k, v in want["losses"].items()}
            grads = _grad_errors(got["grads"], want["grads"])
            bn_err = max((float((got["bn"][k] - v).abs().max() / max(float(v.abs().max()),
                                                                        1e-30))
                          for k, v in want["bn"].items()), default=0.0)
            # each rank's ZeroConvBN outputs against its image's at batch 2
            conv_err = max((float((h["conv_out"][j][0] - w[i]).abs().max() / w[i].abs().max())
                            for i, h in halves for j, w in enumerate(want["conv_out"])),
                           default=0.0)
            # the decoder's query slots given another encoder position than at
            # batch 2, and the slots whose last hidden state is furthest off
            reordered = sum(int((h["topk_idx"][0] != want["topk_idx"][i]).sum())
                            for i, h in halves)
            hs_err = [(h["hs_last"][0] - want["hs_last"][i]).abs().amax(-1)
                      / want["hs_last"][i].abs().max() for i, h in halves]
            # valid targets that a rank matched to other queries than batch 2
            moved = sum(int(((h["assignments"] != want["assignments"][i::2])
                             & batch["gt_valid"][i].cpu()).sum()) for i, h in halves)
            rec = {"loss_max_rel_err": max(errs.values()), "worst_losses": _worst(errs),
                   "grad_max_rel_err": max(grads.values()), "worst_grads": _worst(grads),
                   "bn_stats_max_rel_err": bn_err if want["bn"] else None,
                   "conv_bn_out_max_rel_err": conv_err if want["conv_out"] else None,
                   "slots_reordered": reordered, "assignments_moved": moved,
                   "worst_slots_per_image": [
                       {int(q): float(e[q]) for q in e.argsort(descending=True)[:2]}
                       for e in hs_err]}
            if how == "pinned":
                rec["local_num_boxes_total_rel_err"] = _local_num_boxes_err(
                    [h["local"] for _, h in halves], want["losses"]["total_loss"])
                if rec["local_num_boxes_total_rel_err"] <= DP_TOL:
                    failed.append(f"{preset}: a local num_boxes would pass, "
                                  f"{rec['local_num_boxes_total_rel_err']}")
            result["11b"][f"{preset} {how}"] = rec
            if (rec["loss_max_rel_err"] > loss_tol or rec["grad_max_rel_err"] > grad_tol
                    or max(bn_err, conv_err) > DP_STATS_TOL):
                failed.append(f"{preset} {how} (losses {loss_tol}, gradients {grad_tol}, "
                              f"statistics {DP_STATS_TOL}): {rec}")
    if failed:
        log("11b steps: " + json.dumps(result["11b"]))
        raise AssertionError("11b against batch 2: " + "; ".join(failed))
    result["11b"]["eval"] = _same_detections("11b eval", _images([r["evals"] for r in ranks]),
                                             ref_images, size)
    ap = {k: (ranks[0]["eval"][k], ref_eval[k]) for k in ("AP", "AP50", "AP75")}
    same = json.dumps(ranks[0]["eval"], sort_keys=True) == json.dumps(ranks[1]["eval"],
                                                                       sort_keys=True)
    if any(abs(a - b) > DP_TOL for a, b in ap.values()) or not same:
        raise AssertionError(f"11b: eval_coco --mesh 2 against one process: {ap}")
    result["11b"]["eval"]["ap_mesh2_one"] = ap
    log("11b: " + json.dumps(result["11b"]))
    torch.cuda.empty_cache()

    # 11c: two accumulated calls of one image each against one call at batch 2
    cfg = pc.OptimizerConfig()
    updated = {}
    emas = [0]
    ema_update = optim.ema_update

    def counted(*a, **k):
        emas[0] += 1
        return ema_update(*a, **k)

    # MultiSteps averages the calls' gradients, each call's losses divided by
    # its own counts: halves of equal counts make that batch 2's step
    batch = _dp_inputs(pc, tokenizer_mod, transforms, DP_CARD, (DP_CAPTIONS[0],) * 2,
                       (DP_TARGETS[0],) * 2)
    acc = {}
    for k, micro in ((2, [{n: v[i:i + 1] for n, v in batch.items()} for i in range(2)]),
                     (1, [batch])):
        model = _dp_model(build_model, optim, DP_PRESETS[0], DP_CARD)
        opt = optim.Optimizer(model, cfg, pc.ScheduleConfig(), ema_decay=0.999,
                              batch_size_scale=k)
        emas[0] = 0
        optim.ema_update = counted
        before = lsap_cuda.launches
        try:
            for b in micro:
                step.train_step(model, opt, b)
        finally:
            optim.ema_update = ema_update
        acc[f"k={k}"] = {
            "calls": len(micro),
            "adamw_steps": sorted({int(s["step"]) for s in opt.adamw.state.values()}),
            "schedule_steps": opt.schedule.last_epoch, "ema_updates": emas[0],
            "lsap_launches_per_call": (lsap_cuda.launches - before) / len(micro)}
        if [acc[f"k={k}"][n] for n in ("adamw_steps", "schedule_steps", "ema_updates",
                                        "lsap_launches_per_call")] != [[1], 1, len(micro), 1]:
            raise AssertionError(f"11c k={k}: {acc[f'k={k}']}")
        updated[k] = {n: p.detach().float().cpu() for n, p in opt.params.items()}
        del model, opt
        torch.cuda.empty_cache()
    acc_err = max(_grad_errors(updated[2], updated[1]).values())
    moved = max(float((updated[2][n] - updated[1][n]).abs().max()) for n in updated[1])
    if acc_err > DP_TOL:
        raise AssertionError(f"11c: accumulated update off by {acc_err} of the tensors' scale")
    result["11c"] = {**acc, "param_max_rel_err": acc_err, "param_max_abs_diff": moved}
    result["phase_s"] = time.time() - t0
    shutil.rmtree(root, ignore_errors=True)
    return result


# ---------------------------------------------------------------------------
# 12. the replay's image hooks, few-shot, the other metrics, load_image
# ---------------------------------------------------------------------------

REPLAY_ITERS = 3  # 12a: replay iterations; the image hook gives a batch to the first two
REPLAY_IMAGE_ITERS = 2
REPLAY_CLASSES = ["person", "dog", "cat", "car"]  # 12a's image caption (5 seeded boxes)
REPLAY_SEED = 12  # 12a's dropout generator
REPLAY_LOSS_TOL = 1e-4  # 12a in f32, kernels against the plain MSDA: the total loss, relative
FEWSHOT_ITERS = 2  # 12b: steps a task


def _replay_images(root, memory, inference, optim, step, tokenizer_mod, transforms, pc,
                   msda_forward, msda_backward, card_line) -> dict:
    """12a: `run_replay_phase` with the image hooks on phase 6's seeded
    checkpoint (the reference's COCO-replay configuration): REPLAY_ITERS
    iterations, an 800x1216 image batch (REPLAY_CLASSES, 5 boxes) on the
    first REPLAY_IMAGE_ITERS, None on the rest, the driver's detection loss
    (`train.step.compute_losses`: the criterion, matched by `lsap`) with
    dropout from a CUDA generator, remat on. Checks each iteration's
    launches, the frozen tensors, the adapters' gradients and moves, and the
    merge; then the first image iteration twice more in f32 from the same
    state and generator seed, through the kernels and through
    `ms_deform_attn_plain`."""
    from ziragroundingdino_torch.models import transformer
    from ziragroundingdino_torch.ops import msda
    from ziragroundingdino_torch.train import incremental

    def load(dtype):
        return inference.load_model(str(root / "ckpt.pth"), str(root / "vocab.txt"),
                                    preset="dualzerorepbranchgroundingdino", device="cuda",
                                    dtype=dtype, **REMAT)

    lm = load("bfloat16")
    model, tok, cfg = lm.model, lm.tokenizer, lm.cfg
    learned = [k.strip("-") for k in memory]  # the checkpoint's prompt memory
    tb = tokenizer_mod.tokenize_captions(tok, [" . ".join(REPLAY_CLASSES) + " ."],
                                         max_text_len=cfg.max_text_len,
                                         max_categories=cfg.max_categories)
    pixels, mask = synthetic_image(transforms, pc)
    batch = train_batch(tb, pixels, mask, "cuda", n_labels=len(REPLAY_CLASSES))

    # the replay's own trainable set, to hook the gradients of
    optim.set_trainable(model, optim.ZIRA_TRAINABLE_PATTERNS, freeze_all=True)
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    marks, times, trained = [], [], {}
    peaks = {n: [] for n in trainable}  # (iteration, max |grad|) of each backward
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: peaks[n].append((len(marks) - 1, p.grad.detach().abs().amax())))
        for n, p in model.named_parameters() if n in trainable]

    def mark():
        torch.cuda.synchronize()
        times.append(time.perf_counter())
        marks.append((msda_forward.launches, msda_backward.launches,
                      msda_backward.binned_launches, matcher_counts()[0]))

    given = iter([batch] * REPLAY_IMAGE_ITERS)

    def image_batch_fn():
        mark()
        return next(given, None)

    gen = torch.Generator(device="cuda").manual_seed(REPLAY_SEED)
    rep_merge = incremental.rep_merge

    def merge(m, *a, **k):
        mark()
        trained.update({n: t.detach().clone() for n, t in m.state_dict().items()})
        return rep_merge(m, *a, **k)

    state = incremental.IncrementalState(params=incremental.snapshot(model),
                                         prompt_memory=dict(lm.prompt_memory),
                                         learned_classes=learned)
    incremental.rep_merge = merge
    torch.cuda.reset_peak_memory_stats()
    msda_forward.launches = msda_backward.launches = msda_backward.binned_launches = 0
    try:
        state = incremental.run_replay_phase(
            state, model, tok, iters=REPLAY_ITERS, image_batch_fn=image_batch_fn,
            image_loss_fn=lambda m, b: step.compute_losses(m, b, gen)[0])
    finally:
        incremental.rep_merge = rep_merge
        for h in hooks:
            h.remove()
    peak = torch.cuda.max_memory_allocated()
    per_iter = [[b - a for a, b in zip(marks[i], marks[i + 1])] for i in range(REPLAY_ITERS)]
    iter_ms = [(times[i + 1] - times[i]) * 1e3 for i in range(REPLAY_ITERS)]
    n_layers, n_enc = cfg.enc_layers + cfg.dec_layers, cfg.enc_layers
    image_iter = [n_layers + n_enc, n_layers, n_enc, 1]  # remat recomputes the encoder's 6
    want = [image_iter] * REPLAY_IMAGE_ITERS + [[0, 0, 0, 0]] * (REPLAY_ITERS - REPLAY_IMAGE_ITERS)
    log(f"12a: replay iterations in {[round(x, 2) for x in iter_ms]} ms, launches "
        f"(msda_forward, msda_backward, binned, lsap) per iteration {per_iter}, peak "
        f"{peak / 2**30:.2f} GiB; on {card_line}")
    if per_iter != want:
        raise AssertionError(f"12a launches per iteration {per_iter}, not {want}")

    grads = {n: max((float(g) for it, g in v if it < REPLAY_IMAGE_ITERS), default=0.0)
             for n, v in peaks.items()}
    frozen_changed = [k for k in before if k not in trainable and not torch.equal(before[k],
                                                                                  trained[k])]
    unmoved = [n for n in trainable if torch.equal(before[n], trained[n])]
    ungraded = sorted(n for n, g in grads.items() if not g > 0)
    if frozen_changed:
        raise AssertionError(f"12a: frozen tensors changed: {frozen_changed[:5]}")
    if ungraded or unmoved:
        raise AssertionError(f"12a: adapters without a gradient {ungraded[:5]}, unmoved "
                             f"{unmoved[:5]}")
    merge_err = check_zira_merge("12a", trained, trained, state.params, cfg)
    del model, lm, state, trained, before
    torch.cuda.empty_cache()

    # the first image iteration in f32, through the kernels and through the plain MSDA
    lm = load("float32")
    model = lm.model
    optim.set_trainable(model, optim.ZIRA_TRAINABLE_PATTERNS, freeze_all=True)

    def first_iteration():
        model.zero_grad(set_to_none=True)
        g = torch.Generator(device="cuda").manual_seed(REPLAY_SEED)
        losses = incremental.replay_memory_loss(model, tok, learned, lm.prompt_memory,
                                                cfg.max_text_len)
        total = sum(losses.values()) + step.compute_losses(model, batch, g)[0]
        total.backward()
        return total.item(), {n: p.grad.detach().clone() for n, p in model.named_parameters()
                              if p.requires_grad}

    kernel_loss, kernel_grads = first_iteration()
    plain_calls = [0]

    def plain(*a):
        plain_calls[0] += 1
        return msda.ms_deform_attn_plain(*a)

    launched = msda_forward.launches
    transformer.ms_deform_attn = plain
    try:
        plain_loss, plain_grads = first_iteration()
    finally:
        transformer.ms_deform_attn = msda.ms_deform_attn
    if msda_forward.launches != launched or plain_calls[0] != n_layers + n_enc:
        raise AssertionError(f"12a plain run: {plain_calls[0]} plain calls, "
                             f"{msda_forward.launches - launched} kernel launches")
    loss_err = abs(kernel_loss - plain_loss) / abs(plain_loss)
    grad_err = {n: float((kernel_grads[n] - g).abs().max() / g.abs().max().clamp(min=1e-30))
                for n, g in plain_grads.items()}
    worst = max(grad_err.values())
    log(f"12a in f32, kernels vs plain MSDA: total loss {kernel_loss:.6f} vs {plain_loss:.6f} "
        f"({loss_err:.2e} relative), adapter gradients within {worst:.2e} of their scale")
    if not loss_err <= REPLAY_LOSS_TOL or not worst <= REMAT_GRAD_TOL:
        raise AssertionError(f"12a: f32 kernels vs plain: loss {loss_err}, gradients "
                             f"{sorted(grad_err.items(), key=lambda x: -x[1])[:3]}")
    del model, lm
    torch.cuda.empty_cache()
    return {"iteration_ms": iter_ms, "launches_per_iteration": per_iter,
            "peak_memory_gib": peak / 2**30, "adapters": len(trainable),
            "merge_f32_max_rel_err": merge_err, "f32_total_loss_kernels_plain": [
                kernel_loss, plain_loss], "f32_loss_rel_err": loss_err,
            "f32_grad_max_rel_err": worst}


def _layers(root) -> tuple:
    """(deformable layers, encoder layers) of the model phase 6's overrides
    under `root` build."""
    from ziragroundingdino_torch import config as pc

    cfg = pc.get_model_config("dualzerorepbranchgroundingdino",
                              **pc.load_config_overrides(str(root / "overrides.json"))[0])
    return cfg.enc_layers + cfg.dec_layers, cfg.enc_layers


class _RecordingMeanAP:
    """Stands in for `eval.evaluator.CocoMeanAP`: the evaluator's class,
    keeping each instance, whose entries then feed the other metrics."""

    def __init__(self, cls):
        self.cls, self.made = cls, []

    def __call__(self, *a, **k):
        ev = self.cls(*a, **k)
        self.made.append(ev)
        return ev


def _fewshot_driver(root, card_line, msda_forward, msda_backward) -> tuple:
    """12b: the port's `write_fewshot_json` writes
    `fewshot_train_shot1_seed3.json` for phase 6's two tasks, then
    `train_odinw --shot 1shot` trains FEWSHOT_ITERS steps a task on them
    (remat on), merges and evaluates both. Checks the trained sets' image
    counts against `fewshot_subset`'s, the report's keys and the launches.
    Returns (the numbers, the first task's eval entries)."""
    from ziragroundingdino_torch.data import fewshot, odinw
    from ziragroundingdino_torch.data import loader as loader_mod
    from ziragroundingdino_torch.eval import evaluator
    from ziragroundingdino_torch.scripts import train_odinw

    want_sizes, paths = [], []
    for name in LIFECYCLE_TASKS:
        task = odinw.get_odinw_task(name, str(root / "data"))
        full = task.load_train()
        paths.append(fewshot.write_fewshot_json(full, task.train_root, shots=1))
        want_sizes.append(len(fewshot.fewshot_subset(full, 1)))
    sizes, real_loader = [], loader_mod.DataLoader

    def data_loader(ds, *a, train=False, **k):
        if train:
            sizes.append(len(ds))
        return real_loader(ds, *a, train=train, **k)

    recording = _RecordingMeanAP(evaluator.CocoMeanAP)
    loader_mod.DataLoader, evaluator.CocoMeanAP = data_loader, recording
    args = lifecycle_args(root, root / "fewshot", FEWSHOT_ITERS, FEWSHOT_ITERS, 0) + [
        "--shot", "1shot"]
    msda_forward.launches = msda_backward.launches = msda_backward.binned_launches = 0
    matched = matcher_counts()
    t = time.perf_counter()
    try:
        report = train_odinw.main(args)
        torch.cuda.synchronize()
    finally:
        loader_mod.DataLoader, evaluator.CocoMeanAP = real_loader, recording.cls
    run_s = time.perf_counter() - t
    launches = (msda_forward.launches, msda_backward.launches, msda_backward.binned_launches,
                matcher_counts()[0] - matched[0])
    if matcher_counts()[1] != matched[1]:
        raise AssertionError("12b called the host matcher")
    steps = FEWSHOT_ITERS * len(LIFECYCLE_TASKS)
    batches = sum(-(-n_test // LIFECYCLE_BATCH) for _, _, n_test in LIFECYCLE_TASKS.values())
    n_layers, n_enc = _layers(root)
    want = ((n_layers + n_enc) * steps + n_layers * batches, n_layers * steps, n_enc * steps,
            steps)  # the driver trains with remat: the encoder's layers run twice a step
    log(f"12b: train_odinw --shot 1shot in {run_s:.1f} s: trained sets of {sizes} images "
        f"(fewshot_subset: {want_sizes}, of {[n for _, n, _ in LIFECYCLE_TASKS.values()]}), "
        f"launches (msda_forward, msda_backward, binned, lsap) {launches}, report {report}")
    if sizes != want_sizes:
        raise AssertionError(f"12b trained on {sizes} images, not fewshot_subset's {want_sizes}")
    keys = {f"AP/{n}" for n in LIFECYCLE_TASKS} | {"avg_AP"}
    if set(report) != keys or not all(np.isfinite(v) for v in report.values()):
        raise AssertionError(f"12b report {report}")
    if launches != want:
        raise AssertionError(f"12b launches {launches}, not {want}")
    first = next(iter(LIFECYCLE_TASKS))
    evals = [ev for ev in recording.made if ev.num_classes == len(LIFECYCLE_TASKS[first][0])]
    return {"run_s": run_s, "trained_images": sizes, "fewshot_subset_images": want_sizes,
            "json": [pathlib.Path(p).name for p in paths], "launches": launches,
            "report": report}, evals[0]


def _load_image_and_metrics(root, coco_eval, inference, transforms, msda_forward,
                            card_line) -> dict:
    """12c: a task image through `utils.inference.load_image` and
    `predict` on the card, bitwise against the `data.transforms` route;
    the first task's eval detections of 12b scored by `VocMeanAP` and
    `LvisMeanAP` (every category common, no negatives) beside `CocoMeanAP`."""
    from ziragroundingdino_torch.data import odinw
    from ziragroundingdino_torch.eval.lvis_map import LvisMeanAP
    from ziragroundingdino_torch.eval.voc_map import VocMeanAP

    first = next(iter(LIFECYCLE_TASKS))
    path = pathlib.Path(odinw.get_odinw_task(first, str(root / "data")).test_root) / "0.ppm"
    src, (pixels, mask), size = inference.load_image(str(path))
    tsrc, (tpixels, tmask), tsize = transforms.load_image(str(path))
    if not (np.array_equal(src, tsrc) and np.array_equal(pixels, tpixels)
            and np.array_equal(mask, tmask) and tuple(size) == tuple(tsize)):
        raise AssertionError("12c: utils.inference.load_image differs from data.transforms'")
    lm = inference.load_model(str(root / "ckpt.pth"), str(root / "vocab.txt"),
                              preset="dualzerorepbranchgroundingdino", device="cuda",
                              dtype="bfloat16")
    caption = " . ".join(LIFECYCLE_TASKS[first][0]) + " ."
    msda_forward.launches = 0
    got = inference.predict(lm, pixels, mask, caption, box_threshold=0.0)
    want = inference.predict(lm, tpixels, tmask, caption, box_threshold=0.0)
    launches = msda_forward.launches
    if not (all(np.array_equal(a, b) for a, b in zip(got[:2], want[:2])) and got[2] == want[2]):
        raise AssertionError("12c: predict on load_image's arrays differs")
    if launches != 2 * _layers(root)[0] or not len(got[0]):
        raise AssertionError(f"12c: {launches} msda_forward launches for 2 requests, "
                             f"{len(got[0])} boxes")
    del lm
    torch.cuda.empty_cache()

    n = coco_eval.num_classes
    voc, lvis = VocMeanAP(num_classes=n), LvisMeanAP(num_classes=n, category_frequency=["c"] * n)
    for image_id, db, ds, dl, gb, gl, *_ in coco_eval.entries:
        voc.add(image_id, db, ds, dl, gb, gl)
        lvis.add(image_id, db, ds, dl, gb, gl)
        lvis.add_image_meta(image_id, [], [])
    lvis_res = lvis.summarize()
    scores = {"coco_AP": coco_eval.summarize()["AP"] / 100, "voc_mAP": voc.summarize()["mAP"] / 100,
              "lvis_AP": lvis_res["AP"] / 100, "lvis_APc": lvis_res["APc"] / 100}
    log(f"12c: load_image {tuple(size)} in bucket {tuple(pixels.shape[1:3])}, predict bitwise "
        f"the data.transforms route ({len(got[0])} boxes, {launches} msda_forward launches); "
        f"task {first}'s {len(coco_eval.entries)} eval images: {scores} (random weights: the "
        f"path runs, the AP means nothing)")
    if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in scores.values()):
        raise AssertionError(f"12c metrics {scores}")
    return {"image": str(path.name), "size": list(size), "boxes": len(got[0]),
            "launches": launches, "metrics": scores}


def phase_replay_and_metrics(build_model, inference, optim, step, tokenizer_mod, transforms, pc,
                             msda_forward, msda_backward, card_line) -> dict:
    """Phase 12 under `build/phase12` (removed after): phase 6's seeded
    checkpoint and tasks, then 12a, 12b and 12c."""
    root = pathlib.Path(__file__).resolve().parent / "build" / "phase12"
    t0 = time.time()
    _, memory, _ = write_lifecycle_inputs(build_model, root)
    inputs_s = time.time() - t0
    result = {"inputs_s": inputs_s, "card": card_line}
    result["12a"] = _replay_images(root, memory, inference, optim, step, tokenizer_mod,
                                   transforms, pc, msda_forward, msda_backward, card_line)
    result["12b"], coco_eval = _fewshot_driver(root, card_line, msda_forward, msda_backward)
    result["12c"] = _load_image_and_metrics(root, coco_eval, inference, transforms,
                                            msda_forward, card_line)
    result["phase_s"] = time.time() - t0
    shutil.rmtree(root, ignore_errors=True)
    return result


# ---------------------------------------------------------------------------
# 13. tensor and sequence parallelism: ranks sharing the card over gloo
# ---------------------------------------------------------------------------

TP_SP_MESHES = (("13a", (1, 2, 1)), ("13b", (1, 1, 2)))  # (label, (data, model, seq))
TP_SP_ODINW_MESH = (1, 2, 2)  # 13c: four ranks
TP_SP_ITERS = 2  # 13c: steps a task
REQUEST_TOL = 1e-4  # 13a/13b: a request's logits and boxes, of max(1, their scale)
# the collectives of `parallel/dist.py` and `parallel/tp.py`, probed on card
# tensors before 13a
PORT_COLLECTIVES = ("all_reduce_sum", "all_reduce_max", "all_gather", "reduce_scatter",
                    "broadcast")
# 13c against the plain driver. `train_odinw`'s defaults: lr 1e-3, x0.1 from
# 0.4 of a task's steps (so 1e-3, then 1e-4), the freeze weights (the only
# trained tensors a merge keeps) at lr factor 0.2, the branches' scaling
# init 0.1 (`models/zira.py`). AdamW's update from zero moments is at most
# ADAM_STEP_MAX lr in size in its first two steps whatever the gradients,
# so where a gradient element's sign differs between two runs their copies
# part by at most 2 ADAM_STEP_MAX lr a step. Per task a freeze element
# parts by 0.2 D from its own steps and by (0.1 + D / 2) D + D (D / 2) from
# the merge `freeze += scaling * branch` (scaling and branch each within
# D / 2 of their init, D apart), with D = 2 ADAM_STEP_MAX (1e-3 + 1e-4);
# tasks add up. Tensors that no task trains stay bitwise.
ADAM_STEP_MAX = 1.0014  # max |m_hat / sqrt(v_hat)| at steps 1-2, betas (0.9, 0.999)
CHAIN_D = 2 * ADAM_STEP_MAX * (1e-3 + 1e-4)
CHAIN_TOL = 2 * (0.2 * CHAIN_D + (0.1 + CHAIN_D / 2) * CHAIN_D + CHAIN_D * CHAIN_D / 2)
CHAIN_EVAL_TOL = 0.1  # 13c's eval scores and boxes (of the image size): ~3x the readings


def _probe_collectives() -> dict:
    """PORT_COLLECTIVES on f32 and bf16 card tensors of the default group
    (gloo, ranks sharing the card), each checked; raises naming the first
    one that gloo refuses or gets wrong."""
    import torch.distributed as tdist

    rank, n = tdist.get_rank(), tdist.get_world_size()
    found = {}
    for name in PORT_COLLECTIVES:
        for dt in (torch.float32, torch.bfloat16):
            x = torch.full((4,), float(rank + 1), device=DP_CARD, dtype=dt)
            try:
                if name == "all_reduce_sum":
                    tdist.all_reduce(x)
                    got, want = x[0], n * (n + 1) / 2
                elif name == "all_reduce_max":
                    tdist.all_reduce(x, op=tdist.ReduceOp.MAX)
                    got, want = x[0], n
                elif name == "all_gather":
                    parts = [torch.empty_like(x) for _ in range(n)]
                    tdist.all_gather(parts, x)
                    got, want = sum(q[0] for q in parts), n * (n + 1) / 2
                elif name == "reduce_scatter":
                    tdist.reduce_scatter(x, [x.clone() for _ in range(n)])
                    got, want = x[0], n * (n + 1) / 2
                else:
                    tdist.broadcast(x, src=0)
                    got, want = x[0], 1
                torch.cuda.synchronize()
            except Exception as e:
                raise AssertionError(f"phase 13: gloo refuses {name} on {dt} card tensors: "
                                     f"{e}") from e
            if float(got) != float(want):
                raise AssertionError(f"phase 13: gloo's {name} on {dt} card tensors gave "
                                     f"{float(got)}, not {want}")
            found[f"{name}/{str(dt)[6:]}"] = "ok"
    return found


def run_ranks13(kind: str, n: int, root: pathlib.Path, timeout: int = 600) -> float:
    """This script's phase 13 worker `kind` in n processes of
    `torch.distributed.run`, as `run_ranks`; returns the wall seconds."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(n),
           "--master_addr", "127.0.0.1", "--master_port", str(_free_port()),
           str(WORKER), "--phase13-worker", kind, "--phase13-root", str(root)]
    t = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    (root / f"worker13_{kind}.log").write_text(res.stdout + res.stderr)
    if res.returncode:
        tail = "\n".join((res.stdout + res.stderr).splitlines()[-60:])
        raise AssertionError(f"phase 13 worker {kind} on {n} ranks exited {res.returncode}:\n"
                             f"{tail}")
    return time.perf_counter() - t


def _replicas(params: dict) -> dict:
    """{name: sha256 of its bytes} of the trainable parameters that are not
    tensor-parallel shards: what every model and seq rank must hold
    bitwise alike."""
    import hashlib

    from ziragroundingdino_torch.parallel import tp

    return {n: hashlib.sha256(p.detach().float().cpu().numpy().tobytes()).hexdigest()
            for n, p in params.items() if p.requires_grad and not tp.is_sharded(p)}


def _finite(t: torch.Tensor) -> torch.Tensor:
    """The entries no mask set (|x| < 1e6)."""
    t = t.float()
    return t[t.abs() < 1e6]


class _MsdaRecorder:
    """Around `ops.msda.ms_deform_attn` (the query-sharded path's call) and
    the model's own: each call's (value tokens, queries), and the first
    call's inputs and output where the queries are a chunk of the tokens."""

    def __init__(self):
        from ziragroundingdino_torch.models import transformer
        from ziragroundingdino_torch.ops import msda

        self.mods, self.orig = (transformer, msda), msda.ms_deform_attn
        self.calls, self.first = [], None

    def __call__(self, value, shapes, loc, attn):
        out = self.orig(value, shapes, loc, attn)
        self.calls.append((value.shape[1], loc.shape[1]))
        if self.first is None and loc.shape[1] < value.shape[1] == sum(h * w for h, w in shapes):
            self.first = tuple(t.detach().clone() for t in (value, loc, attn, out)) + (shapes,)
        return out

    def __enter__(self):
        for m in self.mods:
            m.ms_deform_attn = self
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m.ms_deform_attn = self.orig


def _tp_sp_run(build_model, optim, step, batch, mesh=None, pinned=None,
               preset: str = DP_PRESETS[0], microbatches=None, dropout_seed=None) -> dict:
    """`preset` (the ZiRa one unless named) at full width (DP_DTYPE, remat,
    phase 11's seeded weights, CAT's adapters drawn by
    `_seeded_pet_modules`) on `batch`: one request (the eval forward) and
    two train steps (the second timed) under `mesh` (sharded by
    `parallel.tp.shard_model_`, in `sequence_parallel` where it has a seq
    axis, in `pipeline_parallel(mesh, microbatches)` where it has a pipe
    axis), or in this process alone without one, recording the queries it
    chose and the assignments it used; with `pinned` (the one process's
    record) it replays them. The steps are the driver's optimizer's (AdamW
    at lr 1e-3, clip 0.1); with `dropout_seed`, a step with dropout from a
    CUDA generator of that seed comes first, its gradients kept and the
    weights left as they are (`_GradKeeper`). Returns the request's
    detections, the first AdamW step's losses and trainable gradients
    (whole, zeros where the backward left None; this rank's, as the
    backward leaves them: before the optimizer's mean over the model and
    pipe axes), those of the dropout step and its launches where it ran,
    the launches of each AdamW step (and the binned
    `msda_backward` ones), the MSDA calls' shapes and the first
    query-sharded call, the sharded weights' element counts, whether the
    sharded model's `state_dict()` is the one process's weights bitwise,
    the replicated trainable weights' digests after the steps (`_replicas`),
    the encoder layers each forward ran, the pipeline's transfers a step,
    step ms and peak memory; under a pipe axis also a digest of
    `state_dict()` after the steps."""
    from ziragroundingdino_torch.models import transformer
    from ziragroundingdino_torch.ops.lsap import lsap_cuda
    from ziragroundingdino_torch.ops.msda_cuda import msda_backward, msda_forward
    from ziragroundingdino_torch.parallel import pp, sp, tp
    from ziragroundingdino_torch.train import criterion

    model = _dp_model(build_model, optim, preset, DP_CARD, **REMAT)
    if model.cfg.use_adapter:
        _seeded_pet_modules(model)
    whole = {k: v.detach().clone() for k, v in model.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    targets = tp.shard_model_(model, mesh) if mesh is not None else {}
    params = dict(model.named_parameters())
    counts = [(params[n].numel(), int(np.prod(params[n].tp.full_shape))) for n in targets]
    full = model.state_dict()
    full_bitwise = sorted(full) == sorted(whole) and all(torch.equal(v, whole[k])
                                                         for k, v in full.items())
    del full
    piped = mesh is not None and mesh.pipe > 1
    ctx = (pp.pipeline_parallel(mesh, microbatches) if piped
           else sp.sequence_parallel(mesh) if mesh is not None and mesh.seq > 1
           else contextlib.nullcontext())
    counters = (msda_forward, msda_backward, lsap_cuda)
    text = {k: batch[k] for k in step.TEXT_KEYS}
    opt = optim.Optimizer(model, optim.OptimizerConfig(lr=1e-3, grad_clip=0.1))
    first = {}
    layer_calls = []
    hooks = [layer.register_forward_hook(lambda m, a, o, i=i: layer_calls.append(i))
             for i, layer in enumerate(model.transformer.encoder.layers)]

    def capture():
        first.update((n, (torch.zeros_like(p) if p.grad is None else p.grad).detach().float()
                      .cpu()) for n, p in opt.params.items())
        del opt.step
        return opt.step()

    opt.step = capture
    net = step.wrap_ddp(model) if mesh is not None and step.ddp_applies() else model
    chosen, used = [], []
    select_topk, match_batch = transformer.select_topk, criterion.match_batch

    # the run's own query choices and assignments (the request's, then each
    # step's), and with `pinned` the one process's, which the run replays
    def selected(scores, k):
        chosen.append(select_topk(scores, k))
        return (chosen[-1] if pinned is None
                else pinned["topk_idx"][len(chosen) - 1].to(scores.device))

    def matched(logits, *a, **k):
        used.append(match_batch(logits, *a, **k))  # the `lsap` launch
        return (used[-1] if pinned is None
                else pinned["assignments"][len(used) - 1].to(logits.device))

    launches, binned, ms, transfers, step_layers = [], [], [], [], []
    transformer.select_topk, criterion.match_batch = selected, matched
    with ctx, _MsdaRecorder() as rec:
        try:
            before = tuple(c.launches for c in counters)
            with torch.no_grad():
                out = model(batch["pixels"], batch["mask"], text)
            request = {k: out[k].float().cpu() for k in ("pred_logits", "pred_boxes")}
            request_launches = tuple(c.launches - b for c, b in zip(counters, before))
            request_layers, layer_calls[:] = list(layer_calls), []
            dropout = None
            if dropout_seed is not None:
                keeper = _GradKeeper(model)
                before = tuple(c.launches for c in counters)
                before_binned = msda_backward.binned_launches
                metrics = step.train_step(
                    net, keeper, batch, torch.Generator(device=DP_CARD).manual_seed(dropout_seed))
                dropout = {
                    "losses": {k: float(v) for k, v in metrics.items() if k != "grad_norm"},
                    "grads": {n: (params[n].tp.full_of(g.to(DP_CARD)).cpu() if n in targets
                                  else g) for n, g in keeper.grads.items()},
                    "launches": tuple(c.launches - b for c, b in zip(counters, before)),
                    "binned": msda_backward.binned_launches - before_binned,
                    "layers": sorted(set(layer_calls))}
                layer_calls[:] = []
            for i in range(2):
                before = tuple(c.launches for c in counters)
                before_binned, before_counts = msda_backward.binned_launches, dict(pp.COUNTS)
                torch.cuda.synchronize()
                t = time.perf_counter()
                metrics = step.train_step(net, opt, batch)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
                launches.append(tuple(c.launches - b for c, b in zip(counters, before)))
                binned.append(msda_backward.binned_launches - before_binned)
                transfers.append({k: v - before_counts[k] for k, v in pp.COUNTS.items()})
                step_layers.append(sorted(set(layer_calls)))
                layer_calls[:] = []
                if i == 0:
                    losses = {k: float(v) for k, v in metrics.items() if k != "grad_norm"}
                    grads = {n: (params[n].tp.full_of(g.to(DP_CARD)).cpu() if n in targets
                                 else g) for n, g in first.items()}
        finally:
            transformer.select_topk, criterion.match_batch = select_topk, match_batch
            for h in hooks:
                h.remove()
    cfg = model.cfg
    result = {"layers": (cfg.enc_layers, cfg.dec_layers),
              "request": request, "request_launches": request_launches, "losses": losses,
              "grads": grads, "launches": launches, "step_ms": ms,
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
              "msda_calls": rec.calls, "sharded": counts, "full_bitwise": full_bitwise,
              "replicas": _replicas(params),
              "topk_idx": [c.cpu() for c in chosen], "assignments": [u.cpu() for u in used],
              "slots_reordered": (0 if pinned is None else sum(
                  int((c.cpu() != p).sum()) for c, p in zip(chosen, pinned["topk_idx"]))),
              "assignments_moved": (0 if pinned is None else sum(
                  int((u.cpu() != p).sum()) for u, p in zip(used, pinned["assignments"]))),
              "binned": binned, "request_layers": request_layers, "step_layers": step_layers,
              "transfers": transfers, "dropout": dropout}
    if piped:
        import hashlib

        digest = hashlib.sha256()
        for k, v in sorted(model.state_dict().items()):
            digest.update(k.encode() + v.detach().float().cpu().numpy().tobytes())
        result["state_digest"] = digest.hexdigest()
    if rec.first is not None:
        from ziragroundingdino_torch.ops.msda import ms_deform_attn_plain

        value, loc, attn, got, shapes = rec.first
        want = ms_deform_attn_plain(value.float(), shapes, loc, attn)
        result["sharded_launch"] = {
            "value_tokens": value.shape[1], "queries": loc.shape[1],
            "max_abs_err": float((got.float() - want).abs().max()),
            "tol": F32_TOL * max(1.0, float(want.abs().max()))}
    del net, model, opt
    torch.cuda.empty_cache()
    return result


def phase13_worker(kind: str, root: pathlib.Path) -> None:
    """A rank of phase 13, started by `run_ranks13` over gloo on the shared
    card: "ab", `_probe_collectives`, then 13a and 13b (`_tp_sp_run` under
    each TP_SP_MESHES mesh, replaying the one process's queries and
    assignments); "c", `train_odinw --mesh 1,2,2` with `_StepProbe`.
    Writes its record to `root/<kind>_rank<r>.pt`."""
    import os

    from ziragroundingdino_torch import config as pc
    from ziragroundingdino_torch.data import transforms
    from ziragroundingdino_torch.models import build_model
    from ziragroundingdino_torch.parallel import dist
    from ziragroundingdino_torch.parallel import mesh as pmesh
    from ziragroundingdino_torch.scripts import train_odinw
    from ziragroundingdino_torch.text import tokenizer as tokenizer_mod
    from ziragroundingdino_torch.train import optim, step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ["RANK"])
    dist.init_from_env(DP_CARD, "gloo")
    out = {}
    if kind == "ab":
        out["collectives"] = _probe_collectives()
        batch = _dp_inputs(pc, tokenizer_mod, transforms, DP_CARD)
        pinned = torch.load(root / "pinned.pt")
        for label, sizes in TP_SP_MESHES:
            out[label] = _tp_sp_run(build_model, optim, step, batch, pmesh.make_mesh(*sizes),
                                    pinned)
    else:
        spec = json.loads((root / "spec.json").read_text())
        probe = _StepProbe(replicas=True).install()
        torch.cuda.reset_peak_memory_stats()
        try:
            t = time.perf_counter()
            out["report"] = train_odinw.main(spec["train_args"] + [
                "--mesh", ",".join(map(str, TP_SP_ODINW_MESH)), "--device", DP_CARD])
            out["run_s"] = time.perf_counter() - t
        finally:
            probe.restore()
        out.update(probe.record(), peak=torch.cuda.max_memory_allocated())
    dist.destroy()
    torch.save(out, root / f"{kind}_rank{rank}.pt")


def _replicas_differ(digests: list) -> list:
    """The names whose `_replicas` digest is not the same on every rank."""
    return sorted(n for n in set().union(*digests)
                  if len({d.get(n) for d in digests}) > 1)


def _request_err(got: dict, want: dict) -> float:
    return max(float((_finite(got[k]) - _finite(want[k])).abs().max())
               / max(1.0, float(_finite(want[k]).abs().max())) for k in want)


def phase_tensor_sequence_parallel(build_model, optim, step, tokenizer_mod, transforms, pc,
                                   card_line):
    """13, the ZiRa preset at full width from phase 6's seeded checkpoint and
    tasks under `build/phase13` (removed after), ranks sharing the card over
    gloo (`torch.distributed.run`, this script with --phase13-worker), f32
    (DP_DTYPE):
    13a `make_mesh(1, 2)` (TP) and 13b `make_mesh(1, 1, 2)` (SP), two ranks,
      after PORT_COLLECTIVES are probed on card tensors (f32 and bf16):
      a request and two train steps at batch 2 against this process at
      batch 2, the query choice and assignments replayed: the first step's
      losses within DP_PINNED_TOL[0], every trainable gradient within
      DP_PINNED_TOL[1] of its scale, the request's logits and boxes within
      REQUEST_TOL, the rank's TP-sharded weights at half their element
      count, the sharded model's `state_dict()` bitwise the one process's
      weights, every rank's replicated trainable weights bitwise alike
      after the two AdamW steps; DP_LAUNCHES a
      step and 12 `msda_forward` a request on every rank; under SP each
      rank's encoder `msda_forward` runs its query chunk against the whole
      value table (the decoder's 450 of 900 queries against the whole
      memory) and equals `ms_deform_attn_plain` there within phase 3's
      F32_TOL;
    13c `train_odinw --mesh 1,2,2`, four ranks, 2 tasks x TP_SP_ITERS steps,
      the merge and the eval, against the plain run here: the first step's
      losses and gradients within DP_TOL (each run its own queries and
      assignments, as 11b's), every rank's replicated trainable
      weights bitwise alike after every step, the chained states' tensors
      that no task trains bitwise the plain run's and the others within
      CHAIN_TOL, the same images in the same order with as many detections
      and the scores and boxes within CHAIN_EVAL_TOL, the ZiRa merge held
      by `check_zira_merge`, DP_LAUNCHES a step on every rank.
    Each rank's peak memory and step ms beside one process's."""
    from ziragroundingdino_torch.scripts import train_odinw

    root = pathlib.Path(__file__).resolve().parent / "build" / "phase13"
    t0 = time.time()
    before_all, _, _ = write_lifecycle_inputs(build_model, root)
    overrides = json.loads((root / "overrides.json").read_text())
    overrides["model"]["compute_dtype"] = DP_DTYPE
    (root / "overrides.json").write_text(json.dumps(overrides))
    train_args = lifecycle_args(root, root / "mesh", TP_SP_ITERS, TP_SP_ITERS, 0)
    (root / "spec.json").write_text(json.dumps({"train_args": train_args}))
    result = {"card": card_line}

    # 13a/13b: this process at batch 2, then two ranks each way
    batch = _dp_inputs(pc, tokenizer_mod, transforms, DP_CARD)
    ref = _tp_sp_run(build_model, optim, step, batch)
    torch.save({k: ref[k] for k in ("topk_idx", "assignments")}, root / "pinned.pt")
    del batch
    torch.cuda.empty_cache()
    launch_s = run_ranks13("ab", 2, root)
    ranks = [torch.load(root / f"ab_rank{r}.pt", weights_only=False) for r in range(2)]
    result["gloo_on_card_tensors"] = ranks[0]["collectives"]
    result["one_process"] = {"step_ms": ref["step_ms"], "peak_gib": ref["peak_gib"],
                             "launches": ref["launches"]}
    enc, dec_layers = ref["layers"]
    want_launches = (2 * enc + dec_layers, enc + dec_layers, 1)  # remat: the encoder twice
    failed = []
    for label, (_, model, seq) in TP_SP_MESHES:
        recs = []
        for r, rank in enumerate(ranks):
            got = rank[label]
            errs = {k: abs(got["losses"][k] - v) / max(abs(v), 1e-30)
                    for k, v in ref["losses"].items()}
            grads = _grad_errors(got["grads"], ref["grads"])
            rec = {"loss_max_rel_err": max(errs.values()), "worst_losses": _worst(errs),
                   "grad_max_rel_err": max(grads.values()), "worst_grads": _worst(grads),
                   "request_max_err": _request_err(got["request"], ref["request"]),
                   "state_dict_bitwise": got["full_bitwise"],
                   "sharded_weights": len(got["sharded"]),
                   "sharded_elements": [sum(c[0] for c in got["sharded"]),
                                        sum(c[1] for c in got["sharded"])],
                   "launches_per_step": got["launches"],
                   "own_slots_reordered": got["slots_reordered"],
                   "own_assignments_moved": got["assignments_moved"],
                   "request_launches": got["request_launches"],
                   "step_ms": got["step_ms"], "peak_gib": got["peak_gib"]}
            if seq > 1:
                # the request's first encoder and first decoder call
                n_tok, q = ref["msda_calls"][0][0], ref["msda_calls"][enc][1]
                chunk, dec = -(-n_tok // seq), -(-q // seq)
                n = enc + dec_layers
                rec["msda_calls_of_the_request"] = got["msda_calls"][:n]
                rec["sharded_launch"] = got.get("sharded_launch")
                want_calls = [(n_tok, chunk)] * enc + [(n_tok, dec)] * dec_layers
                if got["msda_calls"][:n] != want_calls:
                    failed.append(f"{label} rank {r}: MSDA calls {got['msda_calls'][:n]}, "
                                  f"not {want_calls}")
                sl = rec["sharded_launch"]
                if sl is None or sl["max_abs_err"] > sl["tol"] or sl["queries"] != chunk:
                    failed.append(f"{label} rank {r}: the sharded launch against the plain "
                                  f"MSDA: {sl}")
            if model > 1:
                if not got["sharded"] or any(2 * a != b for a, b in got["sharded"]):
                    failed.append(f"{label} rank {r}: sharded weights {got['sharded'][:3]}")
            elif got["sharded"]:
                failed.append(f"{label} rank {r}: {len(got['sharded'])} weights sharded")
            if (rec["loss_max_rel_err"] > DP_PINNED_TOL[0]
                    or rec["grad_max_rel_err"] > DP_PINNED_TOL[1]
                    or rec["request_max_err"] > REQUEST_TOL or not got["full_bitwise"]
                    or got["launches"] != [want_launches] * 2
                    or got["request_launches"][:2] != (enc + dec_layers, 0)):
                failed.append(f"{label} rank {r} (losses {DP_PINNED_TOL[0]}, gradients "
                              f"{DP_PINNED_TOL[1]}, request {REQUEST_TOL}): {rec}")
            recs.append(rec)
        differ = _replicas_differ([rank[label]["replicas"] for rank in ranks])
        if differ:
            failed.append(f"{label}: the ranks' replicated weights differ after the steps: "
                          f"{differ[:4]} ({len(differ)})")
        result[label] = {"mesh": [1, model, seq], "ranks": recs,
                         "replicated_weights_bitwise_alike": not differ,
                         "replicated_weights": len(ranks[0][label]["replicas"])}
    result["13ab_launch_s"] = launch_s
    log("13a/13b: " + json.dumps({k: result[k] for k in ("one_process", "13a", "13b")}))
    if failed:
        raise AssertionError("13a/13b against one process: " + "; ".join(failed))

    # 13c: the plain driver here, then --mesh 1,2,2 on four ranks
    probe = _StepProbe().install()
    torch.cuda.reset_peak_memory_stats()
    try:
        t = time.perf_counter()
        train_odinw.main(lifecycle_args(root, root / "plain", TP_SP_ITERS, TP_SP_ITERS, 0))
        plain_s = time.perf_counter() - t
    finally:
        probe.restore()
    plain = probe.record()
    plain_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    launch_s = run_ranks13("c", 4, root)
    meshed = [torch.load(root / f"c_rank{r}.pt", weights_only=False) for r in range(4)]
    steps = TP_SP_ITERS * len(LIFECYCLE_TASKS)
    failed = []
    if plain["launches"] != [want_launches] * steps:
        failed.append(f"plain: launches a step {plain['launches']}")
    size = float(max(LIFECYCLE_ORIG))
    first, evals = [], []
    for r, rec in enumerate(meshed):
        if rec["launches"] != [want_launches] * steps:
            failed.append(f"rank {r}: launches a step {rec['launches']}, not "
                          f"{want_launches} x {steps}")
        if rec["report"] != meshed[0]["report"]:
            failed.append(f"rank {r}'s report {rec['report']}")
        errs = {k: abs(float(rec["losses"][k]) - float(v)) / max(abs(float(v)), 1e-30)
                for k, v in plain["losses"].items()}
        grads = _grad_errors(rec["grads"], plain["grads"])
        first.append({"loss_max_rel_err": max(errs.values()), "worst_losses": _worst(errs),
                      "grad_max_rel_err": max(grads.values()), "worst_grads": _worst(grads)})
        # each run chooses its own queries and assignments, as 11b's unpinned
        if max(errs.values()) > DP_TOL or max(grads.values()) > DP_TOL:
            failed.append(f"rank {r}'s first step against the plain run's ({DP_TOL}): "
                          f"{first[-1]}")
        try:
            evals.append(_same_detections(f"eval rank {r}", _images([rec["evals"]]),
                                          _images([plain["evals"]]), size, tol=None))
        except AssertionError as e:
            failed.append(str(e))
            continue
        if max(evals[-1]["score_max_abs_err"], evals[-1]["box_max_err_of_size"]) > CHAIN_EVAL_TOL:
            failed.append(f"eval rank {r} against the plain run (scores and boxes "
                          f"{CHAIN_EVAL_TOL}): {evals[-1]}")
    replicas_differ = [_replicas_differ([rec["replicas"][i] for rec in meshed])
                       for i in range(steps)]
    if any(replicas_differ):
        failed.append(f"the ranks' replicated weights differ after steps: {replicas_differ}")
    cfg = pc.get_model_config(DP_PRESETS[0])
    before, merge_err, chain_err, frozen_moved = before_all, 0.0, 0.0, []
    for name in LIFECYCLE_TASKS:
        final = torch.load(root / "mesh" / name / "state_final.pt", map_location="cpu",
                           weights_only=True)["params"]
        trained = torch.load(root / "mesh" / name / "ckpt" / f"step_{TP_SP_ITERS}.pt",
                             map_location="cpu", weights_only=True)["model"]
        merge_err = max(merge_err, check_zira_merge(f"13c task {name}", before, trained,
                                                    final, cfg))
        one = torch.load(root / "plain" / name / "state_final.pt", map_location="cpu",
                         weights_only=True)["params"]
        if sorted(one) != sorted(final) or any(one[k].shape != v.shape
                                               for k, v in final.items()):
            raise AssertionError(f"13c task {name}: the chained state's keys or shapes")
        frozen_moved += [f"{name}/{k}" for k, v in one.items()
                         if "adapter" not in k and not torch.equal(final[k], v)]
        chain_err = max(chain_err, max(float((final[k] - v).abs().max())
                                       for k, v in one.items() if "adapter" in k))
        before = final
    if frozen_moved or chain_err > CHAIN_TOL:
        failed.append(f"chained state against the plain run: untrained tensors that differ "
                      f"{frozen_moved[:4]}, trained ones {chain_err} (limit {CHAIN_TOL})")
    result["13c"] = {
        "mesh": list(TP_SP_ODINW_MESH), "report": meshed[0]["report"],
        "plain_report": json.loads((root / "plain" / "result.json").read_text()),
        "first_step_vs_plain": first, "eval_vs_plain": evals,
        "replicated_weights_bitwise_alike": not any(replicas_differ),
        "merge_f32_max_rel_err": merge_err,
        "chained_state_max_abs_diff_vs_plain": chain_err, "chain_tol": CHAIN_TOL,
        "step_ms_per_rank": [rec["ms"] for rec in meshed], "step_ms_plain": plain["ms"],
        "peak_gib_per_rank": [rec["peak"] / 2**30 for rec in meshed],
        "peak_gib_plain": plain_peak,
        "launches_per_step": meshed[0]["launches"][0], "run_s_per_rank":
            [rec["run_s"] for rec in meshed], "plain_run_s": plain_s, "launch_s": launch_s}
    log("13c: " + json.dumps(result["13c"]))
    if failed:
        raise AssertionError("13c against the plain run: " + "; ".join(failed))
    result["phase_s"] = time.time() - t0
    shutil.rmtree(root, ignore_errors=True)
    return result


# (label, (data, model, pipe), preset, the seed of a first step with dropout
# or None)
PP_MESHES = (("14a", (1, 1, 2), "dualzerorepbranchgroundingdino", 14),
             ("14b", (1, 2, 2), "catgroundingdino", None))
PP_MICRO = 2  # microbatches: the local batch of 2 in two
ENCODER_LAYERS = tuple(f"transformer.encoder.{k}." for k in ("layers", "text_layers",
                                                             "fusion_layers"))


def run_ranks14(kind: str, n: int, root: pathlib.Path, timeout: int = 600) -> float:
    """This script's phase 14 worker `kind` in n processes of
    `torch.distributed.run`, as `run_ranks13`; returns the wall seconds."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(n),
           "--master_addr", "127.0.0.1", "--master_port", str(_free_port()),
           str(WORKER), "--phase14-worker", kind, "--phase14-root", str(root)]
    t = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    (root / f"worker14_{kind}.log").write_text(res.stdout + res.stderr)
    if res.returncode:
        tail = "\n".join((res.stdout + res.stderr).splitlines()[-60:])
        raise AssertionError(f"phase 14 worker {kind} on {n} ranks exited {res.returncode}:\n"
                             f"{tail}")
    return time.perf_counter() - t


def phase14_worker(label: str, root: pathlib.Path) -> None:
    """A rank of phase 14 `label` (a PP_MESHES entry), started by
    `run_ranks14` over gloo on the shared card: `_tp_sp_run` of its preset
    under `make_mesh(data, model, 1, pipe)` in `pipeline_parallel` with
    PP_MICRO microbatches, replaying the one process's queries and
    assignments. Writes its record to `root/<label>_rank<r>.pt`."""
    import os

    from ziragroundingdino_torch import config as pc
    from ziragroundingdino_torch.data import transforms
    from ziragroundingdino_torch.models import build_model
    from ziragroundingdino_torch.parallel import dist
    from ziragroundingdino_torch.parallel import mesh as pmesh
    from ziragroundingdino_torch.text import tokenizer as tokenizer_mod
    from ziragroundingdino_torch.train import optim, step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ["RANK"])
    dist.init_from_env(DP_CARD, "gloo")
    _, (data, model, pipe), preset, seed = next(m for m in PP_MESHES if m[0] == label)
    batch = _dp_inputs(pc, tokenizer_mod, transforms, DP_CARD)
    pinned = torch.load(root / f"pinned_{label}.pt")
    mesh = pmesh.make_mesh(data, model, 1, pipe)
    out = _tp_sp_run(build_model, optim, step, batch, mesh, pinned, preset=preset,
                     microbatches=PP_MICRO, dropout_seed=seed)
    out["coords"] = (mesh.axes["data"][2], mesh.axes["pipe"][2], mesh.axes["model"][2])
    dist.destroy()
    torch.save(out, root / f"{label}_rank{rank}.pt")


def phase_pipeline_parallel(build_model, optim, step, tokenizer_mod, transforms, pc,
                            card_line):
    """14, pipeline parallelism over the encoder's layers at full width under
    `build/phase14` (removed after), ranks sharing the card over gloo
    (`torch.distributed.run`, this script with --phase14-worker), f32
    (DP_DTYPE), remat on, PP_MICRO microbatches:
    14a `make_mesh(1, pipe=2)`, two ranks, the ZiRa preset (3 encoder layers
      a stage);
    14b `make_mesh(1, model=2, pipe=2)`, four ranks, CAT (whose in-layer
      adapters are stage-owned and whose adapter loss crosses the stages),
      its adapters drawn by `_seeded_pet_modules`;
    each a request and two AdamW steps at batch 2 against this process at
    batch 2 (14a first a step with dropout from a seeded CUDA generator,
    whose masks each stage takes a microbatch's rows of, and remat
    replays), the query choice and assignments replayed: the first step's
    (and the dropout step's) losses within DP_PINNED_TOL[0], every
    trainable gradient (as the backward leaves it on the rank: an encoder
    layer's summed over the pipe line) within DP_PINNED_TOL[1] of its
    scale, the dropout step's losses away from the first AdamW step's, the request's
    logits and boxes within REQUEST_TOL, every rank's trainable weights
    and `state_dict()` bitwise alike after the steps; each rank runs its
    own stage's layers alone, and a step joins 2 PP_MICRO transfers a
    neighbouring stage and 2 broadcasts over the pipe line. Each rank's
    launches a step and a request, binned launches, step ms and peak
    memory beside one process's."""
    root = pathlib.Path(__file__).resolve().parent / "build" / "phase14"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t0 = time.time()
    result = {"card": card_line}
    batch = _dp_inputs(pc, tokenizer_mod, transforms, DP_CARD)
    refs = {}
    for label, _, preset, seed in PP_MESHES:
        refs[label] = _tp_sp_run(build_model, optim, step, batch, preset=preset,
                                 dropout_seed=seed)
        torch.save({k: refs[label][k] for k in ("topk_idx", "assignments")},
                   root / f"pinned_{label}.pt")
        torch.cuda.empty_cache()
    del batch
    torch.cuda.empty_cache()
    failed = []
    for label, (data, model, pipe), preset, seed in PP_MESHES:
        n = data * model * pipe
        launch_s = run_ranks14(label, n, root)
        ranks = [torch.load(root / f"{label}_rank{r}.pt", weights_only=False) for r in range(n)]
        ref = refs[label]
        enc, dec_layers = ref["layers"]
        chunk = enc // pipe
        # remat: each stage's layers twice, once a microbatch
        want = (2 * chunk * PP_MICRO + dec_layers, chunk * PP_MICRO + dec_layers, 1)
        # an encoder layer's gradients, where the preset trains one, take one
        # all-reduce over the pipe line a step
        stage_trained = int(any(n.startswith(ENCODER_LAYERS) for n in ref["grads"]))
        if ref["dropout"] is not None:
            moved = abs(ref["dropout"]["losses"]["total_loss"] - ref["losses"]["total_loss"])
            if moved <= 1e-4 * abs(ref["losses"]["total_loss"]):
                failed.append(f"{label}: the dropout step's loss is the plain step's ({moved})")
        recs = []
        for r, got in enumerate(ranks):
            d, p, m = got["coords"]
            own = list(range(p * chunk, (p + 1) * chunk))
            neighbours = (p > 0) + (p < pipe - 1)
            errs = {k: abs(got["losses"][k] - v) / max(abs(v), 1e-30)
                    for k, v in ref["losses"].items()}
            grads = _grad_errors(got["grads"], ref["grads"])
            rec = {"coords": [d, p, m], "loss_max_rel_err": max(errs.values()),
                   "worst_losses": _worst(errs), "grad_max_rel_err": max(grads.values()),
                   "worst_grads": _worst(grads),
                   "request_max_err": _request_err(got["request"], ref["request"]),
                   "state_dict_bitwise_before": got["full_bitwise"],
                   "launches_per_step": got["launches"], "binned_per_step": got["binned"],
                   "request_launches": got["request_launches"],
                   "request_layers": got["request_layers"], "step_layers": got["step_layers"],
                   "transfers_per_step": got["transfers"],
                   "own_slots_reordered": got["slots_reordered"],
                   "own_assignments_moved": got["assignments_moved"],
                   "step_ms": got["step_ms"], "peak_gib": got["peak_gib"]}
            bad_dropout = False
            if ref["dropout"] is not None:
                dref, dgot = ref["dropout"], got["dropout"]
                derrs = {k: abs(dgot["losses"][k] - v) / max(abs(v), 1e-30)
                         for k, v in dref["losses"].items()}
                dgrads = _grad_errors(dgot["grads"], dref["grads"])
                rec["dropout_step"] = {
                    "loss_max_rel_err": max(derrs.values()), "worst_losses": _worst(derrs),
                    "grad_max_rel_err": max(dgrads.values()), "worst_grads": _worst(dgrads),
                    "launches": dgot["launches"], "binned": dgot["binned"],
                    "layers": dgot["layers"]}
                bad_dropout = (max(derrs.values()) > DP_PINNED_TOL[0]
                               or max(dgrads.values()) > DP_PINNED_TOL[1]
                               or dgot["launches"] != want or dgot["binned"] != chunk * PP_MICRO
                               or dgot["layers"] != own)
            if (bad_dropout or rec["loss_max_rel_err"] > DP_PINNED_TOL[0]
                    or rec["grad_max_rel_err"] > DP_PINNED_TOL[1]
                    or rec["request_max_err"] > REQUEST_TOL or not got["full_bitwise"]
                    or got["launches"] != [want] * 2
                    or got["binned"] != [chunk * PP_MICRO] * 2
                    or got["request_launches"][:2] != (chunk * PP_MICRO + dec_layers, 0)
                    or got["request_layers"] != own * PP_MICRO
                    or got["step_layers"] != [own] * 2
                    or got["transfers"] != [{"boundary": 2 * PP_MICRO * neighbours,
                                             "pipe": 2, "grads": stage_trained}] * 2):
                failed.append(f"{label} rank {r} (losses {DP_PINNED_TOL[0]}, gradients "
                              f"{DP_PINNED_TOL[1]}, request {REQUEST_TOL}, launches {want}): "
                              f"{rec}")
            recs.append(rec)
        if sorted(rec["coords"] for rec in recs) != [[d, p, m] for d in range(data)
                                                     for p in range(pipe) for m in range(model)]:
            failed.append(f"{label}: coordinates {[rec['coords'] for rec in recs]}")
        differ = _replicas_differ([rank["replicas"] for rank in ranks])
        digests = {rank["state_digest"] for rank in ranks}
        if differ or len(digests) != 1:
            failed.append(f"{label}: the ranks' weights differ after the steps: trainable "
                          f"{differ[:4]} ({len(differ)}), state_dict digests {len(digests)}")
        result[label] = {"mesh": {"data": data, "model": model, "pipe": pipe}, "preset": preset,
                         "microbatches": PP_MICRO, "dropout_seed": seed, "ranks": recs,
                         "trainable_weights_bitwise_alike": not differ,
                         "state_dict_bitwise_alike": len(digests) == 1,
                         "trainable_weights": len(ranks[0]["replicas"]),
                         "one_process": {"step_ms": ref["step_ms"], "peak_gib": ref["peak_gib"],
                                         "launches": ref["launches"], "binned": ref["binned"],
                                         "request_launches": ref["request_launches"]},
                         "launch_s": launch_s}
        log(f"{label}: " + json.dumps(result[label]))
    if failed:
        raise AssertionError("14 against one process: " + "; ".join(failed))
    result["phase_s"] = time.time() - t0
    shutil.rmtree(root, ignore_errors=True)
    return result


def _merged_ms(intervals) -> float:
    """Length of the union of (start, end) intervals in microseconds, in ms."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def profile_window(label, fn, n, trace_path: pathlib.Path, card_line):
    """`fn` called n times under torch.profiler (CPU + CUDA): the device busy
    time (union of kernel intervals) over the host wall time of the window,
    and the kernels that take the most time; the trace goes to trace_path.
    The profiler slows the host, so the idle share is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    trace_path.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t) * 1e3
    prof.export_chrome_trace(str(trace_path))
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        raise AssertionError("the profiler recorded no device activity")
    busy_ms = _merged_ms((e.time_range.start, e.time_range.end) for e in kernels)
    by_name = {}
    for e in kernels:
        ms, k = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, k + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    log(f"profile: {n} x {label} under the profiler: window {window_ms:.2f} ms, "
        f"device busy {busy_ms:.2f} ms, idle share {1 - busy_ms / window_ms:.3f}, "
        f"{len(kernels) / n:.0f} device activities per {label}")
    for name, (ms, k) in top:
        log(f"  {ms / n:8.3f} ms/{label} {k // n:5d}x  {name[:110]}")
    summary = {"what": label, "card": card_line, "profiled_window_ms": window_ms,
               "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / window_ms,
               "device_activities_per_call": len(kernels) / n,
               "top_kernels_ms_per_call": {k: v[0] / n for k, v in top}}
    log("profile: " + json.dumps(summary))
    return summary


def phase_profile(inference, request, out_dir: pathlib.Path, card_line, tag=None):
    """Where a request's time goes (only with --profile DIR), after the main
    path's checks (and phase 10a's, `tag` "swin_b"). Two passes over the
    same captions:
      * CUDA events from forward hooks give the stream time of BERT, Swin,
        the encoder, the decoder and the whole forward (the rest of the
        forward is input projections, query selection and the heads);
      * `profile_window` over the requests: device busy time, idle share,
        top kernels; its trace goes to DIR/trace.json.gz (DIR/<tag>_trace...)."""
    model, lm, pixels, mask, captions = request
    spans = {"forward": model, "bert": model.bert, "swin": model.backbone[0],
             "encoder": model.transformer.encoder, "decoder": model.transformer.decoder}
    marks = {name: [] for name in spans}

    def hooks(name):
        def pre(mod, args):
            marks[name].append([torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True)])
            marks[name][-1][0].record()

        def post(mod, args, out):
            marks[name][-1][1].record()
        return pre, post

    handles = []
    for name, mod in spans.items():
        pre, post = hooks(name)
        handles += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    wall = []
    try:
        for caption in captions:
            torch.cuda.synchronize()
            t = time.perf_counter()
            inference.predict(lm, pixels, mask, caption)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t) * 1e3)
    finally:
        for h in handles:
            h.remove()
    stream = {name: statistics.median(a.elapsed_time(b) for a, b in pairs)
              for name, pairs in marks.items()}
    stream["other"] = stream["forward"] - sum(v for k, v in stream.items() if k != "forward")
    log(f"profile{f' ({tag})' if tag else ''}: request wall median "
        f"{statistics.median(wall):.2f} ms; stream ms (median of {len(captions)}): "
        + ", ".join(f"{k} {v:.2f}" for k, v in stream.items()) + f"; on {card_line}")
    caps = iter(captions * 2)
    profile_window(f"{tag} request" if tag else "request",
                   lambda: inference.predict(lm, pixels, mask, next(caps)), len(captions),
                   out_dir / (f"{tag}_trace.json.gz" if tag else "trace.json.gz"), card_line)
    return stream


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", type=pathlib.Path, default=None, metavar="DIR",
                        help="also profile requests of the main path; trace to DIR")
    parser.add_argument("--phase11-worker", choices=["a", "b"], default=None,
                        help=argparse.SUPPRESS)  # a rank of phase 11, started by run_ranks
    parser.add_argument("--phase11-root", type=pathlib.Path, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--phase12", action="store_true",
                        help="build the kernels and run phase 12 alone (no result line)")
    parser.add_argument("--phase3c", action="store_true",
                        help="build the kernels and run phase 3c alone (no result line)")
    parser.add_argument("--phase3d", action="store_true",
                        help="build the kernels, run phase 3d and phase 5's requests (no "
                             "result line)")
    parser.add_argument("--phase13", action="store_true",
                        help="build the kernels and run phase 13 alone (no result line)")
    parser.add_argument("--phase13-worker", choices=["ab", "c"], default=None,
                        help=argparse.SUPPRESS)  # a rank of phase 13, started by run_ranks13
    parser.add_argument("--phase13-root", type=pathlib.Path, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--phase14", action="store_true",
                        help="build the kernels and run phase 14 alone (no result line)")
    parser.add_argument("--phase14-worker", choices=[m[0] for m in PP_MESHES], default=None,
                        help=argparse.SUPPRESS)  # a rank of phase 14, started by run_ranks14
    parser.add_argument("--phase14-root", type=pathlib.Path, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if args.phase11_worker:
        phase11_worker(args.phase11_worker, args.phase11_root)
        return 0
    if args.phase13_worker:
        phase13_worker(args.phase13_worker, args.phase13_root)
        return 0
    if args.phase14_worker:
        phase14_worker(args.phase14_worker, args.phase14_root)
        return 0
    from ziragroundingdino_torch import config as pc
    from ziragroundingdino_torch.data import transforms
    from ziragroundingdino_torch.models import build_model
    from ziragroundingdino_torch.ops import cuda_build
    from ziragroundingdino_torch.ops.msda import (
        ms_deform_attn_backward_plain,
        ms_deform_attn_plain,
    )
    from ziragroundingdino_torch.ops import msda_cuda
    from ziragroundingdino_torch.ops.msda_cuda import msda_backward, msda_forward
    from ziragroundingdino_torch.ops import fusion_attn
    from ziragroundingdino_torch.ops import lsap as lsap_mod
    from ziragroundingdino_torch.text import tokenizer as tokenizer_mod
    from ziragroundingdino_torch.train import criterion, matcher, optim, step
    from ziragroundingdino_torch.utils import inference

    # 1. card
    kind = torch.cuda.get_device_name(0)
    card_line = nvidia_smi_line()
    log(f"device: {kind}; nvidia-smi: {card_line}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.time()
    cuda_build.build_all()
    log(f"build: {sorted(cuda_build.sources())} in {time.time() - t0:.2f} s")
    for name in cuda_build.sources():
        if not check_ptxas(name, cuda_build.log_path(name).read_text()):
            raise AssertionError(f"no ptxas report for {name}.cu")
    if args.phase3c:
        log("phase 3c: " + json.dumps(phase_lsap(lsap_mod, matcher)))
        return 0
    if args.phase3d:
        log("phase 3d: " + json.dumps(phase_fusion_attention(fusion_attn)))
        phase_main_path(build_model, inference, tokenizer_mod, transforms, pc, msda_forward,
                        msda_backward, card_line)
        return 0
    if args.phase13:
        log("phase 13: " + json.dumps(phase_tensor_sequence_parallel(
            build_model, optim, step, tokenizer_mod, transforms, pc, card_line)))
        return 0
    if args.phase14:
        log("phase 14: " + json.dumps(phase_pipeline_parallel(
            build_model, optim, step, tokenizer_mod, transforms, pc, card_line)))
        return 0
    if args.phase12:
        count_scipy_calls(matcher)
        log("phase 12: " + json.dumps(phase_replay_and_metrics(
            build_model, inference, optim, step, tokenizer_mod, transforms, pc, msda_forward,
            msda_backward, card_line)))
        return 0

    # 3. kernels vs plain
    rec = phase_kernels(msda_forward, ms_deform_attn_plain)
    rec_bwd = phase_backward(msda_cuda, ms_deform_attn_backward_plain)
    count_scipy_calls(matcher)
    rec_lsap = phase_lsap(lsap_mod, matcher)
    rec_fusion = phase_fusion_attention(fusion_attn)
    torch.cuda.empty_cache()

    # 4. whole model, card vs CPU: serving, then the train step
    models = tiny_models(pc, build_model, tokenizer_mod)
    phase_model_card_vs_cpu(models)
    phase_train_card_vs_cpu(models, criterion, optim, step, msda_forward, msda_backward)
    del models

    # 5. main path at full width: serving, then training
    fused_before = fusion_attn.fusion_attention.launches
    launches, request = phase_main_path(build_model, inference, tokenizer_mod, transforms, pc,
                                        msda_forward, msda_backward, card_line)
    fused_launches = fusion_attn.fusion_attention.launches - fused_before
    if args.profile is not None:
        phase_profile(inference, request, args.profile, card_line)
    del request
    torch.cuda.empty_cache()
    (train_fwd, train_bwd, train_binned, train_lsap), step_ms, peak, matchers = \
        phase_train_main_path(build_model, optim, step, tokenizer_mod, transforms, pc,
                              msda_forward, msda_backward, card_line, args.profile)
    torch.cuda.empty_cache()

    # 6. the ZiRa lifecycle at full width
    life_fwd, life_bwd, life_binned, life_lsap = phase_lifecycle(build_model, msda_forward, msda_backward,
                                                      card_line)
    torch.cuda.empty_cache()

    # 7. the released model served (7a, 7b), the rest of the ZiRa family (7c)
    vanilla_fwd, zira_from_vanilla_fwd, vanilla = phase_vanilla(
        build_model, inference, transforms, msda_forward, msda_backward, card_line)
    torch.cuda.empty_cache()
    family_launches, family = phase_family(build_model, optim, step, tokenizer_mod, transforms,
                                           pc, msda_forward, msda_backward, card_line)
    torch.cuda.empty_cache()

    # 8. the PET baselines and CAT (8a), the dt model through the driver (8b)
    t8 = time.time()
    pet_launches, pet = phase_pet(build_model, inference, optim, step, tokenizer_mod,
                                  transforms, pc, msda_forward, msda_backward, card_line)
    torch.cuda.empty_cache()
    matched = matcher_counts()
    pet_driver_launches, pet_driver = phase_pet_driver(build_model, msda_forward,
                                                       msda_backward, card_line)
    phase_8b_lsap = matcher_counts()[0] - matched[0]
    pet_s = time.time() - t8
    torch.cuda.empty_cache()

    # 9. the Predictor: one CUDA graph per key
    predictor_launches, predictor = phase_predictor(
        build_model, inference, tokenizer_mod, transforms, pc, msda_forward, card_line,
        args.profile)
    torch.cuda.empty_cache()

    # 10. every architecture switch: GroundingDINO-B, ResNet-50, Swin-L, the
    # ablation switches, train_odinw on Swin-B
    matched = matcher_counts()
    arch_launches, arch = phase_architectures(build_model, inference, optim, step,
                                              tokenizer_mod, transforms, pc, msda_forward,
                                              msda_backward, card_line, args.profile)
    phase_10_lsap = matcher_counts()[0] - matched[0]
    torch.cuda.empty_cache()

    # 11. data parallelism: --mesh over NCCL, two ranks on the card, accumulation
    data_parallel = phase_data_parallel(build_model, optim, step, tokenizer_mod,
                                        transforms, pc, msda_forward, msda_backward, card_line)
    torch.cuda.empty_cache()

    # 12. the replay's image hooks, few-shot, VOC/LVIS mAP and load_image
    replay = phase_replay_and_metrics(build_model, inference, optim, step, tokenizer_mod,
                                      transforms, pc, msda_forward, msda_backward, card_line)
    phase_12 = {"12a_per_iteration": replay["12a"]["launches_per_iteration"],
                "12b": replay["12b"]["launches"], "12c": replay["12c"]["launches"]}
    torch.cuda.empty_cache()

    # 13. tensor and sequence parallelism: ranks sharing the card over gloo
    tp_sp = phase_tensor_sequence_parallel(build_model, optim, step, tokenizer_mod,
                                           transforms, pc, card_line)

    def phase_13_launches(i):
        """Each mesh's launches a step on rank 0, the kernel's `i`th count."""
        return {"13a": tp_sp["13a"]["ranks"][0]["launches_per_step"][0][i],
                "13b": tp_sp["13b"]["ranks"][0]["launches_per_step"][0][i],
                "13c": tp_sp["13c"]["launches_per_step"][i]}

    # 14. pipeline parallelism: ranks sharing the card over gloo
    torch.cuda.empty_cache()
    pipe_parallel = phase_pipeline_parallel(build_model, optim, step, tokenizer_mod,
                                            transforms, pc, card_line)

    def phase_14_launches(i):
        """Each mesh's launches a step on every rank, the kernel's `i`th
        count, and (`i` None) the binned `msda_backward` ones."""
        return {label: [r["binned_per_step"][0] if i is None else r["launches_per_step"][0][i]
                        for r in pipe_parallel[label]["ranks"]] for label, *_ in PP_MESHES}

    # result
    enc, dec = rec["encoder"], rec["decoder"]
    benc = rec_bwd["encoder", "binned"]  # the path of the main path's encoder calls
    kernels = [{
        "name": "msda_forward",
        "route": "cuda",
        "source": "ziragroundingdino_torch/csrc/msda_forward.cu",
        "replaces": f"{tpu_kernel_file()}:72",
        "launches": launches,
        "max_abs_err": enc["max_abs_err"],
        "ms": enc["ms"],
        "plain_ms": enc["plain_ms"],
        "bound_ms": enc["bound_ms"],
        "bound_by": enc["bound_by"],
        "library_ms": None,
        "timed_at": "encoder call, bf16 value, B=1 Q=S=20197 H=8 D=32 L=P=4",
        "device_ms": enc["device_ms"],
        "cold_l2_device_ms": enc["cold_l2_device_ms"],
        "l2_gather_mb": enc["l2_gather_mb"],
        "host_us": rec["host_us"],
        "train_launches": train_fwd,
        "lifecycle_launches": life_fwd,
        "vanilla_serving_launches": vanilla_fwd,
        "zira_from_vanilla_launches": zira_from_vanilla_fwd,
        "family_train_launches": {k: v[0] for k, v in family_launches.items()},
        "pet_serving_launches": {k: v[0] for k, v in pet_launches.items()},
        "pet_train_launches": {k: v[1][0] for k, v in pet_launches.items()},
        "pet_driver_launches": pet_driver_launches[0],
        "predictor_launches": predictor_launches,
        "predictor_launches_are": "warm-up runs and one capture per key through the wrapper; "
                                  "each replay launches the captured 12 without it",
        "phase_10_launches": {
            "10a_requests": arch_launches["10a"],
            "10b_first_step_no_remat_remat": [arch_launches["10b"]["first_step"][0][0],
                                              arch_launches["10b"]["first_step"][1][0]],
            "10b_steps": arch_launches["10b"]["steps"][0],
            "10c_request": arch_launches["10c"]["request"],
            "10c_steps": arch_launches["10c"]["steps"][0],
            "10c_finetune": arch_launches["10c"]["finetune"][0], "10d": arch_launches["10d"],
            "10e": arch_launches["10e"], "10f": arch_launches["10f"][0]},
        "phase_11a_launches_per_step": data_parallel["11a"]["launches_per_step"][
            "msda_forward"],
        "phase_12_launches": {"12a_per_iteration": [it[0] for it in
                                                    phase_12["12a_per_iteration"]],
                              "12b": phase_12["12b"][0], "12c": phase_12["12c"]},
        "phase_13_launches_per_rank_step": phase_13_launches(0),
        "phase_14_launches_per_rank_step": phase_14_launches(0),
        "decoder": {k: dec[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                        "max_abs_err", "l2_gather_mb")},
        "decoder_timed_at": "decoder call, bf16 value, B=1 Q=900 S=20197 H=8 D=32 L=P=4",
    }, {
        "name": "msda_backward",
        "route": "cuda",
        "source": "ziragroundingdino_torch/csrc/msda_backward.cu",
        "replaces": f"{tpu_kernel_file('msda.py')}:617",
        "launches": train_bwd,
        "max_abs_err": benc["max_abs_err"],
        "ms": benc["ms"],
        "plain_ms": benc["plain_ms"],
        "bound_ms": benc["bound_ms"],
        "bound_by": benc["bound_by"],
        "library_ms": None,
        "timed_at": "encoder call (binned passes), bf16 value and grad_out, B=1 Q=S=20197 "
                    "H=8 D=32 L=P=4; max_abs_err of d_value; launches: calls over the train "
                    f"path's {TRAIN_STEPS} steps (binned_launches of them binned); launch_ms: "
                    "one call under torch.profiler; decoder: Q=900; by path",
        "binned_launches": train_binned,
        "lifecycle_launches": life_bwd,
        "lifecycle_binned_launches": life_binned,
        "family_train_launches": {k: v[1] for k, v in family_launches.items()},
        "family_train_binned_launches": {k: v[2] for k, v in family_launches.items()},
        "pet_train_launches": {k: v[1][1] for k, v in pet_launches.items()},
        "pet_train_binned_launches": {k: v[1][2] for k, v in pet_launches.items()},
        "pet_driver_launches": pet_driver_launches[1],
        "pet_driver_binned_launches": pet_driver_launches[2],
        "phase_10_launches": {"10b_first_step_no_remat_remat": [
            arch_launches["10b"]["first_step"][0][1:], arch_launches["10b"]["first_step"][1][1:]],
            "10b_steps": arch_launches["10b"]["steps"][1:],
            "10c_steps": arch_launches["10c"]["steps"][1:],
            "10c_finetune": arch_launches["10c"]["finetune"][1], "10f": arch_launches["10f"][1:]},
        "phase_11a_launches_per_step": data_parallel["11a"]["launches_per_step"][
            "msda_backward"],
        "phase_12_launches": {"12a_per_iteration": [it[1] for it in
                                                    phase_12["12a_per_iteration"]],
                              "12a_binned_per_iteration": [it[2] for it in
                                                           phase_12["12a_per_iteration"]],
                              "12b": phase_12["12b"][1], "12b_binned": phase_12["12b"][2]},
        "phase_13_launches_per_rank_step": phase_13_launches(1),
        "phase_14_launches_per_rank_step": phase_14_launches(1),
        "phase_14_binned_launches_per_rank_step": phase_14_launches(None),
        "device_ms": benc["device_ms"],
        "launch_ms": benc["launch_ms"],
        "by_path": {f"{name} {path}": {k: v for k, v in r.items() if k != "bound_by"}
                    for (name, path), r in rec_bwd.items()},
    }, {
        "name": "lsap",
        "route": "cuda",
        "source": "ziragroundingdino_torch/csrc/lsap.cu",
        "replaces": f"{tpu_kernel_file('matcher.py', 'train')}:83",
        "launches": train_lsap,
        "max_abs_err": rec_lsap["max_abs_err"],
        "ms": rec_lsap["ms"],
        "plain_ms": rec_lsap["plain_ms"],
        "bound_ms": rec_lsap["bound_ms"],
        "bound_by": rec_lsap["bound_by"],
        "library_ms": None,
        "timed_at": f"the train step's matching at batch 1: P={LSAP_OUTPUTS} problems, Q=900, "
                    "N=5, f32 costs; max_abs_err: assignments, exactly equal in every "
                    "phase 3c case; padded: the lifecycle's N=100 at batch 1 and 2; "
                    "plain_ms: lsap_plain on the card; no PyTorch call solves an assignment, "
                    "scipy_host_ms is the host path (copy, scipy, copy back)",
        "device_ms": rec_lsap["device_ms"],
        "latency_bound_ms": rec_lsap["latency_bound_ms"],
        "latency_bound_pr8_ms": rec_lsap["latency_bound_pr8_ms"],
        "dependent_steps": rec_lsap["dependent_steps"],
        "padded": rec_lsap["padded"],
        "scipy_host_ms": rec_lsap["scipy_host_ms"],
        "plain_cpu_ms": rec_lsap["plain_cpu_ms"],
        "lifecycle_launches": life_lsap,
        "family_train_launches": {k: v["lsap_launches"] for k, v in family.items()},
        "pet_train_launches": {k: v["lsap_launches"] for k, v in pet.items()},
        "phase_8b_launches": phase_8b_lsap,
        "phase_10_launches": phase_10_lsap,
        "phase_11a_launches_per_step": data_parallel["11a"]["launches_per_step"]["lsap"],
        "phase_11c_launches_per_call": {k: v["lsap_launches_per_call"]
                                        for k, v in data_parallel["11c"].items()
                                        if k.startswith("k=")},
        "phase_12_launches": {"12a_per_iteration": [it[3] for it in
                                                    phase_12["12a_per_iteration"]],
                              "12b": phase_12["12b"][3]},
        "phase_13_launches_per_rank_step": phase_13_launches(2),
        "phase_14_launches_per_rank_step": phase_14_launches(2),
    }, {
        "name": "fusion_attention",
        "route": "cuda",
        "source": "ziragroundingdino_torch/csrc/fusion_attn.cu",
        "replaces": None,
        "replaces_why": "no TPU kernel: the JAX fusion leaves it to XLA; added for the "
                        "parent's strided softmax over Nv and its f32 logits in device memory",
        "launches": fused_launches,
        "launches_are": "calls of the family (image->text, text->image, combine) in phase "
                        "5's requests, 6 a request",
        "max_abs_err": max(rec_fusion["coco"]["rel_err"].values()),
        "ms": rec_fusion["coco"]["ms"],
        "plain_ms": rec_fusion["coco"]["plain_ms"],
        "bound_ms": rec_fusion["coco"]["bound_ms"],
        "bound_by": rec_fusion["coco"]["bound_by"],
        "library_ms": rec_fusion["coco"]["library_ms"],
        "timed_at": "serve-coco's request, B=2 Nv=20197 Nl=256, 4 heads of 256, bf16; "
                    "max_abs_err relative to the output's scale; library_ms: the parent's "
                    "matmul + strided softmax path",
        "device_ms": rec_fusion["coco"]["device_ms"],
        "by_case": rec_fusion,
    }]
    log("train_step: " + json.dumps({
        "warm_median_ms": step_ms, "peak_memory_gib": peak / 2**30,
        "at": "dualzerorepbranchgroundingdino, bf16, batch 1, 800x1216"}))
    log("phase 7: " + json.dumps({
        "vanilla_serving": vanilla, "family": family,
        "at": "800x1216, bf16, batch 1; family: " + ", ".join(
            f"{label} = {preset} {extra or ''}".strip() for label, preset, extra in FAMILY)}))
    log("phase 8: " + json.dumps({
        "presets": pet, "driver": pet_driver, "phase_s": pet_s,
        "at": "800x1216, bf16, batch 1, 1 request and 2 steps each; driver: dtgroundingdino, "
              f"batch {PET_BATCH}, {len(PET_TASKS)} tasks x {PET_ITERS} steps, 600x800 originals"}))
    log("phase 9: " + json.dumps({
        "predictor": predictor, "train_step_matcher": matchers,
        "at": "dualzerorepbranchgroundingdino, bf16, 800x1216 bucket; (a) batch 1, (b) 3 "
              "images in batch 4, (c) batch 8, (d) text bucket 128; train_step_matcher: "
              "phase 5b's batch, warm steps in turns"}))
    log("phase 10: " + json.dumps({
        **arch, "card": card_line,
        "at": "800x1216, bf16, BERT-base, d=256, 6+6 layers, 900 queries; 10a/10b/10f Swin-B "
              "384 (window 12), 10c ResNet-50 + learned positions, 10d Swin-L 384, 10e Swin-T "
              "with one ablation switch off"}))
    log("phase 11: " + json.dumps({
        **data_parallel,
        "at": "dualzerorepbranchgroundingdino (11b also repconvbngroundingdino), Swin-T, "
              "11a bf16, 11b/11c f32, "
              f"800x1216 bucket; 11a: train_odinw --mesh 1 under torch.distributed.run (NCCL), "
              f"{len(LIFECYCLE_TASKS)} tasks x {DP_ITERS} steps at batch {LIFECYCLE_BATCH}, "
              "remat on, against the plain run; 11b: 2 ranks on one card over gloo, "
              "global batch 2; 11c: batch_size_scale 2 over two images"}))
    log("phase 12: " + json.dumps({
        **replay,
        "at": "dualzerorepbranchgroundingdino, Swin-T, 800x1216, remat on; 12a bf16 (f32 for "
              f"the kernels-vs-plain rerun), {REPLAY_ITERS} replay iterations, an image batch "
              f"on {REPLAY_IMAGE_ITERS} ({len(REPLAY_CLASSES)} categories, 5 boxes); 12b "
              f"train_odinw --shot 1shot, {len(LIFECYCLE_TASKS)} tasks x {FEWSHOT_ITERS} steps "
              f"at batch {LIFECYCLE_BATCH}; 12c one request twice, and the first task's eval"}))
    log("phase 13: " + json.dumps({
        **tp_sp,
        "at": "dualzerorepbranchgroundingdino, Swin-T, BERT-base, d=256, 6+6 layers, 900 "
              "queries, f32, remat on, 800x1216 bucket; ranks sharing the card over gloo; "
              "13a --mesh 1,2 and 13b --mesh 1,1,2 at batch 2 against one process at batch "
              f"2; 13c train_odinw --mesh 1,2,2, {len(LIFECYCLE_TASKS)} tasks x {TP_SP_ITERS} "
              f"steps at batch {LIFECYCLE_BATCH}, against the plain run; what TP and SP cost "
              "on one card, no scaling"}))
    log("phase 14: " + json.dumps({
        **pipe_parallel,
        "at": "Swin-T, BERT-base, d=256, 6+6 layers, 900 queries, f32, remat on, 800x1216 "
              f"bucket; ranks sharing the card over gloo; {PP_MICRO} microbatches of a batch "
              "of 2, a request and two AdamW steps against one process at batch 2; 14a "
              "ZiRa under make_mesh(1, pipe=2), 14b CAT under make_mesh(1, model=2, pipe=2); "
              "what PP costs on one card, no scaling"}))
    log(json.dumps({"kernels": kernels}))
    log(card_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
