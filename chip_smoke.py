"""Drive the PyTorch port on one NVIDIA card and check it.

    python3 chip_smoke.py [--profile DIR]

Phases, in order (any failure raises, and the script exits non-zero):
  1. card: name, nvidia-smi name and power limit; TF32 off for f32 checks;
  2. build: every CUDA kernel of the port (`msda_forward`, `msda_backward`),
     from its sources, one nvcc each, all at once; each kernel's registers,
     stack frame and spills as ptxas reports them, and a failure if any
     kernel has a stack frame or spills;
  3. kernels vs plain: `msda_forward` against `ms_deform_attn_plain` on the
     card at the encoder shape (Q = S = 20197 at 800x1216), the decoder shape
     (Q = 900), a tail shape (Q = 901: the last block's tile is ragged), an
     edge shape (B = 2, locations exactly 0, exactly 1 and far outside) and a
     ragged shape (D = 16, B = 2, odd levels, locations in [-0.1, 1.1]), f32
     and bf16 value, with timings (CUDA events, median of 20): `ms`, the
     call time (events around the Python call, so the host's time before
     the launch counts, as the first slice timed it) and `device_ms` (a
     spin before the first event hides the host's time, so only the kernel
     counts); at the encoder shape also the device time with L2 flushed
     before every launch; the wrapper's host time per call;
  3b. the same for `msda_backward` against `ms_deform_attn_backward_plain`
     (all three gradients), with the L2 gather and the f32 atomic traffic
     beside the bytes bound;
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
     `msda_backward` launches per step, frozen weights unchanged, every ZiRa
     branch moved; ms per step and peak memory; with --profile, a step's
     device busy time, idle share and top kernels;
  6. result: a `kernels` JSON line, the nvidia-smi line, and last
     `{"ok": true, "device": {...}}`.

It needs a CUDA card and the repository's `ziragroundingdino_torch` package
next to it; without either it fails before printing a result.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
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


def tpu_kernel_file(name: str = "msda_pallas.py") -> str:
    """Path, in this checkout, of a file of the JAX package's `ops/`: the TPU
    kernel that `msda_forward` replaces (`msda_pallas.py`, `pallas_call` at
    line 72) or the MSDA with the hand-written backward that
    `msda_backward` replaces (`msda.py`, the custom VJP at line 617)."""
    root = pathlib.Path(__file__).resolve().parent
    found = sorted(root.glob(f"*/ops/{name}"))
    found = [f for f in found if (f.parent / "msda_pallas.py").exists()]
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
    span = "edges" a fifth each of EDGES' four values, the rest in [0, 1]."""
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
    (per corner 2 flops per channel for the dot with g and 2 for the atomic's
    product and add, plus ~40 per sample). Also returns, beside the bound,
    the bytes of the corner gather (from L2), of the f32 atomic adds into
    d_value (4 corners x D x 4 B per sample) and of the kernel's own f32
    d_value accumulator (zeroed, added into, read by the cast once each)."""
    nbytes = sum(t.numel() * t.element_size() for t in (value, loc, attn, grad_out))
    nbytes += value.numel() * value.element_size() + 4 * (loc.numel() + attn.numel())
    b, q, h, n_levels, n_points, _ = loc.shape
    d = value.shape[-1]
    samples = b * q * h * n_levels * n_points
    flops = samples * (4 * 4 * d + 40)
    gather_bytes = samples * 4 * d * value.element_size()
    atomic_bytes = samples * 4 * d * 4
    accumulator_bytes = 4 * value.numel()
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes,
            gather_bytes, atomic_bytes, accumulator_bytes)


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
        t = re.search(r"kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)ELi(\d+)E", fn or "")
        label = (f"<{'f32' if t.group(1) == 'f' else 'bf16'}, D={t.group(2)}, "
                 f"{'L=P=4' if t.group(3) != '0' else 'generic L, P'}>" if t else fn)
        log(f"  {name}{label}: {regs} registers, {frame} bytes stack frame, "
            f"{stores} bytes spill stores, {loads} bytes spill loads")
        if frame or stores or loads:
            raise AssertionError(f"{name}{label} has a stack frame or spills")
    return len(rows)


# (name, spatial shapes, B, Q, H, D, location span) of phases 3 and 3b
KERNEL_CASES = [
    ("encoder", ENC_SHAPES, 1, ENC_S, 8, 32, (0.0, 1.0)),
    ("decoder", ENC_SHAPES, 1, 900, 8, 32, (0.0, 1.0)),
    ("tail", ENC_SHAPES, 1, 901, 8, 32, (0.0, 1.0)),
    ("edges", ENC_SHAPES, 2, 901, 8, 32, "edges"),
    ("ragged", RAGGED_SHAPES, 2, 37, 3, 16, (-0.1, 1.1)),
]


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


def phase_backward(msda_backward, ms_deform_attn_backward_plain):
    """Backward kernel vs plain backward at phase 3's shapes; returns the
    bf16 measurements at the encoder and decoder shapes for the kernels
    line."""
    record = {}
    for name, shapes, b, q, h, d, span in KERNEL_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            value, loc, attn = msda_inputs(shapes, b, q, h, d, dtype, span)
            g = torch.randn(b, q, h * d, device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(1)).to(dtype)
            want = ms_deform_attn_backward_plain(value.float(), shapes, loc, attn, g.float())
            got = msda_backward(value, shapes, loc, attn, g)
            torch.cuda.synchronize()
            errs = []
            for gname, x, w in zip(("d_value", "d_loc", "d_attn"), got, want):
                scale = max(w.abs().max().item(), 1e-30)
                err = (x.float() - w).abs().max().item()
                tol = BWD_TOL[dtype][gname] * scale
                errs.append(f"{gname} {err:.3e} (scale {scale:.3e}, tol {tol:.3e})")
                if not err <= tol:
                    raise AssertionError(f"msda_backward disagrees with the plain backward at "
                                         f"{name} {dtype}, {gname}: {err} > {tol}")
                if gname == "d_value":
                    d_value_err = err

            def fn():
                return msda_backward(value, shapes, loc, attn, g)

            ms = time_ms(fn)
            device_ms = time_ms(fn, spin=True)
            plain_ms = time_ms(lambda: ms_deform_attn_backward_plain(value, shapes, loc, attn, g),
                               n=5, warmup=1)
            bound_ms, bound_by, nbytes, gather_bytes, atomic_bytes, acc_bytes = (
                msda_backward_bound(value, loc, attn, g))
            log(f"msda_backward {name} {str(dtype)[6:]} B={b} Q={q} H={h} D={d} max_abs_err: "
                + "; ".join(errs) + f"; call_ms={ms:.4f} device_ms={device_ms:.4f} "
                f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}, "
                f"{nbytes / 1e6:.1f} MB) share_of_bound call={bound_ms / ms:.3f} "
                f"device={bound_ms / device_ms:.3f} l2_gather={gather_bytes / 1e6:.1f} MB "
                f"atomics={atomic_bytes / 1e6:.1f} MB "
                f"({atomic_bytes / device_ms / 1e9:.2f} TB/s of atomic adds over device_ms) "
                f"f32_accumulator={acc_bytes / 1e6:.1f} MB")
            if dtype == torch.bfloat16 and name in ("encoder", "decoder"):
                record[name] = dict(max_abs_err=d_value_err, ms=ms, device_ms=device_ms,
                                    plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                    l2_gather_mb=gather_bytes / 1e6,
                                    atomic_mb=atomic_bytes / 1e6,
                                    f32_accumulator_mb=acc_bytes / 1e6)
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

    def record(*args):
        assignments.append(match_batch(*args))
        return assignments[-1]

    results = []
    try:
        for model, dev in ((cpu, "cpu"), (card, "cuda")):
            optim.set_trainable(model, optim.ZIRA_TRAINABLE_PATTERNS)
            if dev == "cpu":
                criterion.match_batch = record
            else:
                replay = iter(assignments)
                criterion.match_batch = lambda *args: next(replay).to(dev)
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


def synthetic_image(transforms, pc):
    """A seeded 800x1199 uint8 image, normalized and padded to its bucket
    (800x1216): pixels [1, H, W, 3], mask [1, H, W]."""
    rng = np.random.RandomState(0)
    image = rng.randint(0, 256, (800, 1199, 3)).astype(np.uint8)
    data_cfg = pc.DataConfig()
    bucket = transforms.pick_bucket(800, 1199, data_cfg.shape_buckets)
    pixels, mask = transforms.pad_to_bucket(transforms.normalize(image, data_cfg), bucket)
    return pixels[None], mask[None]


def phase_main_path(build_model, inference, tokenizer_mod, transforms, pc, msda_forward,
                    msda_backward, card_line):
    t0 = time.time()
    model = build_model("dualzerorepbranchgroundingdino", device="cuda", dtype="bfloat16",
                        seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"main path: built dualzerorepbranchgroundingdino ({n_params / 1e6:.1f} M params, "
        f"bf16 compute) in {time.time() - t0:.1f} s")
    words = ["person", "dog", "cat", "car", "bicycle", "traffic", "light", "zebra", "fish",
             "boat", "bird", "horse", "umbrella", "kite", "bottle", "cup", "the", "a", "left",
             "red", "on", "of", "man", "riding"]
    lm = inference.LoadedModel(model=model, tokenizer=tokenizer_mod.WordPieceTokenizer(
        tokenizer_mod.make_synthetic_vocab(words)))
    cfg = model.cfg
    pixels, mask = synthetic_image(transforms, pc)
    captions = ["person . dog . cat .", "a man riding a bicycle", "red traffic light . car",
                "zebra . horse . bird . kite . umbrella"]

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


def phase_train_main_path(build_model, optim, step, tokenizer_mod, transforms, pc, msda_forward,
                          msda_backward, card_line, profile_dir=None):
    """TRAIN_STEPS train steps of the full-width preset on one synthetic
    800x1216 image, a 4-category caption and 5 seeded boxes, with dropout
    at the preset's rates from a CUDA generator. Returns the launches of
    both kernels over the steps."""
    t0 = time.time()
    model = build_model("dualzerorepbranchgroundingdino", device="cuda", dtype="bfloat16",
                        seed=0)
    optim.set_trainable(model, optim.ZIRA_TRAINABLE_PATTERNS)
    opt = optim.Optimizer(model, pc.OptimizerConfig(), pc.ScheduleConfig())
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if not p.requires_grad}
    start = {n: p.detach().clone() for n, p in opt.params.items()}
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
    msda_forward.launches = msda_backward.launches = 0
    for i in range(TRAIN_STEPS):
        fwd, bwd = msda_forward.launches, msda_backward.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = step.train_step(model, opt, batch, gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        launched = (msda_forward.launches - fwd, msda_backward.launches - bwd)
        loss = metrics["total_loss"].item()
        log(f"train step {i}: {step_ms[-1]:.1f} ms, total_loss {loss:.4f}, grad_norm "
            f"{metrics['grad_norm'].item():.4f}, msda launches (forward, backward) {launched}")
        if not np.isfinite(loss):
            raise AssertionError(f"train step {i}: loss {loss}")
        if launched != (n_layers, n_layers):
            raise AssertionError(f"train step {i} launched (forward, backward) {launched}, "
                                 f"not {n_layers} each")
    launches = (msda_forward.launches, msda_backward.launches)
    peak = torch.cuda.max_memory_allocated()
    moved = [n for n, p in opt.params.items() if not torch.equal(p.detach(), start[n])]
    changed = [n for n, p in model.named_parameters()
               if not p.requires_grad and not torch.equal(p.detach(), frozen[n])]
    log(f"train path: {TRAIN_STEPS} steps at 800x1216, bf16, per-step ms "
        f"{[round(x, 2) for x in step_ms]} (first includes warm-up), warm median "
        f"{statistics.median(step_ms[1:]):.2f} ms, peak memory {peak / 2**30:.2f} GiB; "
        f"{len(moved)} of {len(opt.params)} trainable tensors moved, {len(changed)} frozen "
        f"changed; on {card_line}")
    if changed:
        raise AssertionError(f"frozen parameters changed: {changed[:5]}")
    if len(moved) != len(opt.params):
        raise AssertionError(f"trainable parameters did not move: "
                             f"{sorted(set(opt.params) - set(moved))[:5]}")
    if profile_dir is not None:
        profile_window("train step", lambda: step.train_step(model, opt, batch, gen), 2,
                       profile_dir / "train_trace.json.gz", card_line)
    return launches, statistics.median(step_ms[1:]), peak


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
    log("profile: " + json.dumps({
        "what": label, "card": card_line, "profiled_window_ms": window_ms,
        "device_busy_ms": busy_ms,
        "top_kernels_ms_per_call": {k: v[0] / n for k, v in top}}))


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
    from ziragroundingdino_torch.ops.msda_cuda import msda_backward, msda_forward
    from ziragroundingdino_torch.text import tokenizer as tokenizer_mod
    from ziragroundingdino_torch.train import criterion, optim, step
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
    rec_bwd = phase_backward(msda_backward, ms_deform_attn_backward_plain)

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
    (train_fwd, train_bwd), step_ms, peak = phase_train_main_path(
        build_model, optim, step, tokenizer_mod, transforms, pc, msda_forward, msda_backward,
        card_line, args.profile)

    # 6. result
    enc, dec = rec["encoder"], rec["decoder"]
    benc, bdec = rec_bwd["encoder"], rec_bwd["decoder"]
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
        "timed_at": "encoder call, bf16 value and grad_out, B=1 Q=S=20197 H=8 D=32 L=P=4; "
                    "max_abs_err of d_value; launches over the train path's "
                    f"{TRAIN_STEPS} steps",
        "device_ms": benc["device_ms"],
        "l2_gather_mb": benc["l2_gather_mb"],
        "atomic_mb": benc["atomic_mb"],
        "f32_accumulator_mb": benc["f32_accumulator_mb"],
        "decoder": {k: bdec[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                         "max_abs_err", "l2_gather_mb", "atomic_mb",
                                         "f32_accumulator_mb")},
        "decoder_timed_at": "decoder call, bf16, B=1 Q=900 S=20197 H=8 D=32 L=P=4",
    }]
    log("train_step: " + json.dumps({
        "warm_median_ms": step_ms, "peak_memory_gib": peak / 2**30,
        "at": "dualzerorepbranchgroundingdino, bf16, batch 1, 800x1216"}))
    log(json.dumps({"kernels": kernels}))
    log(card_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
