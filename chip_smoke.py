"""Drive the PyTorch port on one NVIDIA card and check it.

    python3 chip_smoke.py [--profile DIR]

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
     N = 1, 5, 50, 100 and Q, integer costs (ties), padded targets at BIG
     and Q = 901: assignments exactly equal, totals equal to scipy's; the
     call and device time, the host scipy path's time, the bytes bound;
  4. whole model, card vs CPU: a reduced-depth f32 model (tiny Swin/BERT,
     2 + 2 layers) with the same seeded weights on both;
  4b. the same model's train step, card vs CPU: every loss and every
     trainable gradient, the assignments of the CPU's matcher replayed on
     the card (near-ties may flip), so the backward kernel runs inside the
     model;
  5. main path: `dualzerorepbranchgroundingdino` at full width (Swin-T,
     BERT-base, 6 + 6 layers, 900 queries, bf16) answers `predict` requests
     on a synthetic 800x1216 image; every request must launch the MSDA
     kernel 12 times (6 encoder + 6 decoder layers) and its backward never;
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
     tasks; 12 `msda_forward` launches per train step and per eval batch,
     12 `msda_backward` per train step (6 binned), the plain MSDA never;
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
       two synthetic tasks, 2 steps each, the second task's caption with
       the first's classes, prompt capture and eval: only the CET adapter
       changes; a `phase 8: {...}` line with each preset's request ms,
       warm step ms, peak memory and launches;
  9. the Predictor (`utils/predictor.py`) at full width: (a) phase 5's
     image with a 4-category caption, batch 1, 8 requests; (b) three images
     of three sizes with three captions, batch bucket 4; (c) 8 images; (d)
     a caption of over 64 tokens (text bucket 128). Per key one CUDA graph,
     captured once with 12 `msda_forward` launches inside, its replay
     against the eager forward of the same inputs, request ms and img/s;
     (a) against `predict`; the peak memory with every graph alive and the
     shared pool; with --profile a replayed request's idle share; a
     `phase 9: {...}` line, with phase 5b's matcher comparison;
  Phases 5b, 6, 7c and 8 check one `lsap` launch and no host matcher call
  (no copy of the costs to the host) per train step.
  10. result: a `kernels` JSON line, the nvidia-smi line, and last
     `{"ok": true, "device": {...}}`.

It needs a CUDA card and the repository's `ziragroundingdino_torch` package
next to it; without either it fails before printing a result.
"""

from __future__ import annotations

import argparse
import contextlib
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


def launch_breakdown(fn) -> dict:
    """The device time of each launch of one call of `fn` under
    torch.profiler, labelled by pass; returns {label: ms}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)),
                     key=lambda e: e.time_range.start)
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
        names = re.findall(r"(?:msda|lsap)_[a-z_]+", fn or "")
        kernel = names[-1] if names else fn
        t = re.search(r"I(f|13__nv_bfloat16)Li(\d+)E(?:Li(\d+)ELi\d+E)?", fn or "")
        label = kernel + (f"<{'f32' if t.group(1) == 'f' else 'bf16'}, D={t.group(2)}"
                          + ("" if t.group(3) is None else
                             ", L=P=4" if t.group(3) != "0" else ", generic L, P") + ">"
                          if t else "")
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
]
LSAP_TIMED = ("n5", 1)  # the main path's: phase 5b's 5 boxes on one image
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


def lsap_costs(kind: str, p: int, q: int, n: int, seed: int) -> torch.Tensor:
    """Seeded [P, Q, N] f32 costs on the host: uniform in [0, 10), integers
    0..7 (many ties), or uniform with the second half of the targets'
    columns at the matcher's BIG (padded targets)."""
    rng = np.random.RandomState(seed)
    if kind == "integers":
        cost = rng.randint(0, 8, (p, q, n)).astype(np.float32)
    else:
        cost = (10.0 * rng.rand(p, q, n)).astype(np.float32)
    if kind == "big_columns":
        cost[:, :, n // 2:] = 1.0e7  # train/matcher.py::BIG
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
    Times per case: the call (events around it, with the device transpose),
    the device time (a spin first), the host scipy path on the same costs
    (copy to the host, `linear_sum_assignment` per problem, copy back), and
    at the main path's shape the plain version on the card. Returns the
    timed case's record for the kernels line."""
    record = None
    for seed, (name, b, q, n, kind) in enumerate(LSAP_CASES):
        p = LSAP_OUTPUTS * b
        cost = lsap_costs(kind, p, q, n, seed)
        dev = cost.cuda()
        got = lsap_mod.lsap_cuda(dev)
        torch.cuda.synchronize()
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
            f"share {bound_ms / device_ms:.4f})")
        if (name, b) == LSAP_TIMED:
            plain_ms = host_ms(lambda: lsap_mod.lsap_plain(dev), n=3)
            if not torch.equal(lsap_mod.lsap_plain(dev).cpu(), want):
                raise AssertionError("lsap_plain on the card disagrees with it on the host")
            log(f"lsap {name} B={b}: lsap_plain on the card {plain_ms:.2f} ms")
            record = dict(max_abs_err=0.0, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                          plain_cpu_ms=plain_cpu_ms, scipy_host_ms=scipy_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
    return record


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

    captured = {}
    hook = model.register_forward_hook(lambda m, a, out: captured.__setitem__("out", out))
    msda_forward.launches = msda_backward.launches = 0
    request_ms = []
    torch.cuda.reset_peak_memory_stats()
    try:
        for i, caption in enumerate(captions):
            before = msda_forward.launches
            torch.cuda.synchronize()
            t = time.perf_counter()
            boxes, scores, phrases = inference.predict(lm, pixels, mask, caption)
            torch.cuda.synchronize()
            request_ms.append((time.perf_counter() - t) * 1e3)
            out = captured.pop("out")
            launched = msda_forward.launches - before
            logits, pboxes = out["pred_logits"], out["pred_boxes"]
            log(f"request {i}: {caption!r}: {request_ms[-1]:.1f} ms, {len(boxes)} boxes kept, "
                f"msda_forward launches {launched}, phrases {phrases[:3]}")
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


def phase_lifecycle(build_model, msda_forward, msda_backward, card_line):
    """The ZiRa lifecycle at full width through the port's ODinW driver
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
    from ziragroundingdino_torch.data import synthetic
    from ziragroundingdino_torch.eval import evaluator
    from ziragroundingdino_torch.models.zira import ZERO_VALUE
    from ziragroundingdino_torch.ops import msda
    from ziragroundingdino_torch.scripts import train_odinw
    from ziragroundingdino_torch.text.tokenizer import WordPieceTokenizer, make_synthetic_vocab
    from ziragroundingdino_torch.train import incremental
    from ziragroundingdino_torch.train import trainer as trainer_mod
    from ziragroundingdino_torch.utils import inference

    root = pathlib.Path(__file__).resolve().parent / "build" / "lifecycle"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t0 = time.time()
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
    out = root / "out"
    args = ["--checkpoint", str(root / "ckpt.pth"), "--vocab", str(root / "vocab.txt"),
            "--datasets-root", str(root / "data"), "--tasks", ",".join(LIFECYCLE_TASKS),
            "--output-dir", str(out), "--batch-size", str(LIFECYCLE_BATCH),
            "--max-iter", str(LIFECYCLE_ITERS), "--checkpoint-period", str(LIFECYCLE_CKPT),
            "--replay-iters", str(LIFECYCLE_REPLAY),
            "--config-overrides", str(root / "overrides.json")]
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
    want = (n_layers * (steps + batches), n_layers * steps, n_enc * steps)
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
        changed = [k for k, v in params.items() if "adapter" not in k and not torch.equal(v, before[k])]
        if changed:
            raise AssertionError(f"task {name} changed non-ZiRa tensors: {changed[:5]}")
        for mod in ["rep_linear_adapter"] + [f"input_proj_conv_adapter.{i}" for i in range(4)]:
            freeze = "freeze_linear" if mod == "rep_linear_adapter" else "freeze_conv"
            s = trained[f"{mod}.scaling"]
            for part in ("weight", "bias"):
                want_f = trained[f"{mod}.{freeze}.{part}"] + s * trained[f"{mod}.{part}"]
                err = float((params[f"{mod}.{freeze}.{part}"] - want_f).abs().max()
                            / max(1.0, float(want_f.abs().max())))
                merge_err = max(merge_err, err)
                if err > MERGE_TOL:
                    raise AssertionError(f"task {name}: {mod}.{freeze}.{part} off by {err}")
                if not torch.all(params[f"{mod}.{part}"] == ZERO_VALUE):
                    raise AssertionError(f"task {name}: {mod}.{part} not reset")
            reset = cfg.zira_lan_scale if mod == "rep_linear_adapter" else cfg.zira_vis_scale
            if not torch.all(params[f"{mod}.scaling"] == reset):
                raise AssertionError(f"task {name}: {mod}.scaling not reset")
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
    want = (n_layers * FAMILY_STEPS, n_layers * FAMILY_STEPS, cfg.enc_layers * FAMILY_STEPS)
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
    want = (n_layers * (steps + batches), n_layers * steps, n_enc * steps)
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


def phase_profile(inference, request, out_dir: pathlib.Path, card_line):
    """Where a request's time goes (only with --profile DIR), after the main
    path's checks. Two passes over the same captions:
      * CUDA events from forward hooks give the stream time of BERT, Swin,
        the encoder, the decoder and the whole forward (the rest of the
        forward is input projections, query selection and the heads);
      * `profile_window` over the requests: device busy time, idle share,
        top kernels; its trace goes to DIR/trace.json.gz."""
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
    log(f"profile: request wall median {statistics.median(wall):.2f} ms; stream ms (median of "
        f"{len(captions)}): " + ", ".join(f"{k} {v:.2f}" for k, v in stream.items())
        + f"; on {card_line}")
    caps = iter(captions * 2)
    profile_window("request", lambda: inference.predict(lm, pixels, mask, next(caps)),
                   len(captions), out_dir / "trace.json.gz", card_line)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", type=pathlib.Path, default=None, metavar="DIR",
                        help="also profile requests of the main path; trace to DIR")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
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

    # 3. kernels vs plain
    rec = phase_kernels(msda_forward, ms_deform_attn_plain)
    rec_bwd = phase_backward(msda_cuda, ms_deform_attn_backward_plain)
    count_scipy_calls(matcher)
    rec_lsap = phase_lsap(lsap_mod, matcher)

    # 4. whole model, card vs CPU: serving, then the train step
    models = tiny_models(pc, build_model, tokenizer_mod)
    phase_model_card_vs_cpu(models)
    phase_train_card_vs_cpu(models, criterion, optim, step, msda_forward, msda_backward)
    del models

    # 5. main path at full width: serving, then training
    launches, request = phase_main_path(build_model, inference, tokenizer_mod, transforms, pc,
                                        msda_forward, msda_backward, card_line)
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

    # 10. result
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
                    "N=5, f32 costs; ms and device_ms include the device transpose; "
                    "max_abs_err: assignments, exactly equal in every phase 3c case; "
                    "plain_ms: lsap_plain on the card; no PyTorch call solves an assignment, "
                    "scipy_host_ms is the host path (copy, scipy, copy back)",
        "device_ms": rec_lsap["device_ms"],
        "scipy_host_ms": rec_lsap["scipy_host_ms"],
        "plain_cpu_ms": rec_lsap["plain_cpu_ms"],
        "lifecycle_launches": life_lsap,
        "family_train_launches": {k: v["lsap_launches"] for k, v in family.items()},
        "pet_train_launches": {k: v["lsap_launches"] for k, v in pet.items()},
        "phase_8b_launches": phase_8b_lsap,
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
    log(json.dumps({"kernels": kernels}))
    log(card_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
