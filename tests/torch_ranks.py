"""What the spawned gloo ranks of `tests/test_torch_ddp.py` run: `run_ranks`
starts them (`torch.multiprocessing.spawn` on a free local port) and each
rank runs a job of this module. It imports torch, numpy and the port only,
never JAX: every spawned rank imports the module its job lives in, and a
rank that imported JAX and the JAX package too would start seconds later.
"""

import os
import socket
import tempfile

import numpy as np
import torch

from ziragroundingdino_torch.models import build_model
from ziragroundingdino_torch.parallel import dist as pdist
from ziragroundingdino_torch.train import criterion as pcrit
from ziragroundingdino_torch.train import optim as poptim
from ziragroundingdino_torch.train import step as pstep

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(rank, world, port, out_dir, job, args):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(2)
    pdist.init_from_env("cpu")
    try:
        torch.save(job(rank, *args), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        pdist.destroy()


def run_ranks(job, *args, world: int = 2):
    """[job(rank, *args) for each rank], each rank a spawned process in one
    gloo group."""
    with tempfile.TemporaryDirectory() as d:
        torch.multiprocessing.spawn(_rank_entry, args=(world, free_port(), d, job, args),
                                    nprocs=world, join=True)
        return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


class GradRecorder:
    """An optimizer for `train_step` that keeps the gradients it is given."""

    def __init__(self, model):
        self.params = {n: p for n, p in model.named_parameters() if p.requires_grad}
        self.grads = None

    def will_update(self):
        return True

    def step(self):
        self.grads = {n: None if p.grad is None else p.grad.clone()
                      for n, p in self.params.items()}
        for p in self.params.values():
            p.grad = None
        return torch.zeros(())


def job_step(rank, cases):
    """Each case's DDP step on this rank's image, the matcher pinned to
    JAX's assignments of that image: {preset: (global losses, gradients)}."""
    out = {}
    for preset, pcfg, sd, batch, assignments in cases:
        model = build_model(pcfg, device="cpu", dtype="float32")
        model.load_state_dict(sd)
        poptim.set_trainable(model, poptim.trainable_patterns_for_cfg(pcfg),
                             freeze_all=pcfg.freeze_all)
        net = pstep.wrap_ddp(model)
        local = {k: torch.from_numpy(v[rank:rank + 1]).clone() for k, v in batch.items()}
        rows = torch.from_numpy(np.concatenate([a[rank:rank + 1] for a in assignments])).long()
        pcrit.match_batch = lambda *a, **k: rows
        rec = GradRecorder(model)
        metrics = pstep.train_step(net, rec, local)
        out[preset] = ({k: v.item() for k, v in metrics.items() if k != "grad_norm"}, rec.grads)
    return out


EVAL_DATA = dict(train_short_sides=(64, 96), max_size=160, test_short_side=96,
                 shape_buckets=((96, 128), (128, 160), (160, 224)), max_boxes=10, num_workers=0)

SELECT_K = 10


def port_eval(model, json_path, root, vocab, record=None):
    """The port's `inference_on_dataset` over the split at batch 2 (sharded
    by the process group, where there is one), captions tokenized with
    `vocab`; `record` gets each batch's real detections."""
    from ziragroundingdino_torch.config import DataConfig
    from ziragroundingdino_torch.data.coco import CocoDataset
    from ziragroundingdino_torch.data.loader import DataLoader
    from ziragroundingdino_torch.eval import evaluator
    from ziragroundingdino_torch.text.tokenizer import WordPieceTokenizer

    ds = CocoDataset.from_json(json_path, root)
    loader = DataLoader(ds, WordPieceTokenizer(vocab), DataConfig(**EVAL_DATA),
                        batch_size=2, train=False, max_text_len=32, max_categories=8)
    fn = evaluator.make_inference_fn(model, select_k=SELECT_K)

    def recording(batch):
        det = fn(batch)
        if record is not None:
            record.append({k: v.numpy() for k, v in det.items()})
        return det

    batches = []

    def counted():
        for b in loader:
            batches.append(int(b["real_count"]))
            yield b

    res = evaluator.inference_on_dataset(counted(), recording, num_classes=2, num_warmup=0,
                                         class_names=ds.category_names)
    return res, batches


def job_eval(rank, pcfg, sd, json_path, root, vocab, script_args):
    model = build_model(pcfg, device="cpu", dtype="float32")
    model.load_state_dict(sd)
    record = []
    res, reals = port_eval(model, json_path, root, vocab, record)
    from ziragroundingdino_torch.scripts import eval_coco

    by_script = eval_coco.main(script_args + ["--mesh", "2"])
    return res, reals, record, by_script


def job_train_odinw(rank, args):
    from ziragroundingdino_torch.scripts import train_odinw

    return train_odinw.main(args + ["--mesh", "2"])


# ---------------------------------------------------------------------------
# tensor and sequence parallelism (`tests/test_torch_tp_sp.py`)
# ---------------------------------------------------------------------------


def sharded_run(model, pcfg, batch, assignments=None, seed=None, mesh=None):
    """The forward (eval, no gradient) and one train step of `model` on
    `batch` (numpy), the matcher pinned to `assignments` where given and
    dropout drawn from a generator seeded `seed` where given: (pred_logits,
    pred_boxes, losses, the trainable gradients whole). Under `mesh` the
    model is sharded first (`parallel.tp.shard_model_`) and both run in
    `sequence_parallel` where it has a seq axis; the step goes through DDP
    where the gradient axis has more than one rank, as the trainer's."""
    import contextlib

    from ziragroundingdino_torch.parallel import sp, tp

    poptim.set_trainable(model, poptim.trainable_patterns_for_cfg(pcfg),
                         freeze_all=pcfg.freeze_all)
    if mesh is not None:
        tp.shard_model_(model, mesh)
    ctx = (sp.sequence_parallel(mesh) if mesh is not None and mesh.seq > 1
           else contextlib.nullcontext())
    t = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    with ctx:
        with torch.no_grad():
            out = model(t["pixels"], t["mask"], {k: t[k] for k in pstep.TEXT_KEYS})
        net = pstep.wrap_ddp(model) if mesh is not None and pstep.ddp_applies() else model
        rec = GradRecorder(model)
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        orig = pcrit.match_batch
        if assignments is not None:
            rows = torch.from_numpy(np.concatenate(assignments)).long()
            pcrit.match_batch = lambda *a, **k: rows
        try:
            metrics = pstep.train_step(net, rec, t, gen)
        finally:
            pcrit.match_batch = orig
    grads = {}
    for n, g in rec.grads.items():
        p = rec.params[n]
        grads[n] = None if g is None else (p.tp.full_of(g) if tp.is_sharded(p) else g)
    losses = {k: v.item() for k, v in metrics.items() if k != "grad_norm"}
    return out["pred_logits"], out["pred_boxes"], out["topk_idx"], losses, grads


class MsdaShapes:
    """A stand-in for MSDA where the model calls it (`models.transformer`,
    and `ops.msda` for the query-sharded path) that records each call's
    (value tokens, queries) and runs the op."""

    def __init__(self):
        from ziragroundingdino_torch.models import transformer
        from ziragroundingdino_torch.ops import msda

        self.mods, self.orig, self.calls = (transformer, msda), msda.ms_deform_attn, []

    def __call__(self, value, shapes, loc, attn):
        self.calls.append((value.shape[1], loc.shape[1]))
        return self.orig(value, shapes, loc, attn)

    def __enter__(self):
        for m in self.mods:
            m.ms_deform_attn = self
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m.ms_deform_attn = self.orig


class SkewedOptimizer(poptim.Optimizer):
    """The optimizer with every rank's gradients moved apart over an axis
    (`axis`, the model axis unless set) before its step (rank m of the axis
    adds m * 1e-3 to each), as the card's unordered float atomics move
    them; `differed` records whether a replicated gradient then differed
    over the axis (over the pipe axis every gradient: each rank holds whole
    weights)."""

    differed = False
    axis = "model"

    def step(self):
        from ziragroundingdino_torch.parallel import tp

        group, size, m = pdist.axis(self.axis)
        for p in self.params.values():
            if p.grad is not None:
                p.grad.add_(m * 1e-3)
        rep = [p.grad.reshape(-1) for p in self.params.values()
               if p.grad is not None and (self.axis == "pipe" or not tp.is_sharded(p))]
        flat = torch.cat(rep)
        gathered = pdist.gather_cat(flat[None], 0, group, size)
        self.differed |= not all(torch.equal(g, flat) for g in gathered)
        return super().step()


def replica_run(model, pcfg, batch, assignments, mesh, steps: int = 2, axis: str = "model",
                microbatches=None):
    """`steps` train steps of `model` under `mesh` with `SkewedOptimizer`
    over `axis` (AdamW at lr 1e-2, the matcher pinned), in the mesh's
    `pipeline_parallel` (with `microbatches`) or `sequence_parallel` where
    it has such an axis: (whether the ranks' replicated gradients differed
    over `axis` before a step, whether their trainable parameters are
    bitwise equal after the steps: over the model axis the replicated
    ones, over the pipe axis all of them)."""
    import contextlib

    from ziragroundingdino_torch.config import OptimizerConfig, ScheduleConfig
    from ziragroundingdino_torch.parallel import pp, sp, tp

    poptim.set_trainable(model, poptim.trainable_patterns_for_cfg(pcfg),
                         freeze_all=pcfg.freeze_all)
    tp.shard_model_(model, mesh)
    opt = SkewedOptimizer(model, OptimizerConfig(lr=1e-2), ScheduleConfig())
    opt.axis = axis
    net = pstep.wrap_ddp(model) if pstep.ddp_applies() else model
    t = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    rows = torch.from_numpy(np.concatenate(assignments)).long()
    orig, pcrit.match_batch = pcrit.match_batch, lambda *a, **k: rows
    ctx = (pp.pipeline_parallel(mesh, microbatches) if mesh.pipe > 1
           else sp.sequence_parallel(mesh) if mesh.seq > 1 else contextlib.nullcontext())
    try:
        with ctx:
            for _ in range(steps):
                pstep.train_step(net, opt, t)
    finally:
        pcrit.match_batch = orig
    group, size, _ = pdist.axis(axis)
    flat = torch.cat([p.detach().reshape(-1) for p in opt.params.values()
                      if axis == "pipe" or not tp.is_sharded(p)])
    gathered = pdist.gather_cat(flat[None], 0, group, size)
    return opt.differed, all(torch.equal(g, flat) for g in gathered)


def job_tp_sp(rank, sizes, cases, odinw_args=None):
    """Each case's `sharded_run` on a `make_mesh(*sizes)` of the ranks, then
    `train_odinw --mesh` of the same sizes where `odinw_args` are given:
    ({label: (pred_logits, pred_boxes, topk_idx, losses, gradients,
    {sharded weight: (local elements, whole elements)}, whether the
    sharded model's `state_dict()` gave the loaded weights back bitwise,
    each MSDA call's (value tokens, queries))} and, under a model axis,
    {"replicas": the first case's `replica_run`}, the driver's report)."""
    from ziragroundingdino_torch.parallel import mesh as pmesh
    from ziragroundingdino_torch.parallel import tp

    mesh = pmesh.make_mesh(*sizes)
    out = {}
    for label, pcfg, sd, batch, assignments, seed in cases:
        model = build_model(pcfg, device="cpu", dtype="float32")
        model.load_state_dict(sd)
        with MsdaShapes() as shapes:
            res = sharded_run(model, pcfg, batch, assignments, seed, mesh)
        counts = {n: (p.numel(), int(np.prod(p.tp.full_shape)))
                  for n, p in model.named_parameters() if tp.is_sharded(p)}
        model.load_state_dict(sd)
        whole = model.state_dict()
        same = sorted(whole) == sorted(sd) and all(torch.equal(whole[k], v) for k, v in sd.items())
        out[label] = res + (counts, same, shapes.calls)
    if mesh.model > 1:
        _, pcfg, sd, batch, assignments, _ = cases[0]
        model = build_model(pcfg, device="cpu", dtype="float32")
        model.load_state_dict(sd)
        out["replicas"] = replica_run(model, pcfg, batch, assignments, mesh)
    report = None
    if odinw_args is not None:
        from ziragroundingdino_torch.scripts import train_odinw

        report = train_odinw.main(odinw_args + ["--mesh", ",".join(map(str, sizes))])
    return out, report


# ---------------------------------------------------------------------------
# pipeline parallelism (`tests/test_torch_pp.py`)
# ---------------------------------------------------------------------------


class ReducedGrads(GradRecorder):
    """`GradRecorder` that first makes the gradients what the optimizer's
    update takes (`train.optim.Optimizer.step`): zeros where the backward
    left None, one copy over the model and pipe axes; it keeps them whole
    (a tensor-parallel shard gathered)."""

    def step(self):
        from ziragroundingdino_torch.parallel import tp

        for p in self.params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        tp.mean_replicated_grads_(self.params.values())
        out = super().step()
        self.grads = {n: self.params[n].tp.full_of(g) if tp.is_sharded(self.params[n]) else g
                      for n, g in self.grads.items()}
        return out


class LayerCalls:
    """The encoder layers' calls, by index, through forward hooks."""

    def __init__(self, model):
        self.calls = []
        for i, layer in enumerate(model.transformer.encoder.layers):
            layer.register_forward_hook(lambda m, a, o, i=i: self.calls.append(i))

    def take(self):
        out, self.calls[:] = list(self.calls), []
        return out


def local_rows(batch, assignments, data_rank: int, data: int):
    """The data rank's slice of a global numpy batch, and its rows of the
    assignments ([outputs * B, N], output by output)."""
    b = len(batch["pixels"])
    lo, hi = data_rank * b // data, (data_rank + 1) * b // data
    rows = np.asarray(assignments)
    rows = rows.reshape(-1, b, rows.shape[-1])[:, lo:hi].reshape(-1, rows.shape[-1])
    return {k: v[lo:hi] for k, v in batch.items()}, rows


def pipe_run(model, pcfg, batch, assignments, seed=None, mesh=None, microbatches=None):
    """`model`'s eval forward and one train step on `batch` (numpy, this
    rank's), the matcher pinned to `assignments` and dropout drawn from a
    generator seeded `seed` where given, under `pipeline_parallel(mesh,
    microbatches)` where `mesh` is given (sharded first under a model axis,
    the step through DDP where the data axis has more than one rank):
    (pred_logits, pred_boxes, topk_idx, losses, the trainable gradients as
    the optimizer takes them, whole; the eval forward's encoder-layer
    calls, the eval forward's `pp.COUNTS`, the step's)."""
    import contextlib

    from ziragroundingdino_torch.parallel import pp, tp

    poptim.set_trainable(model, poptim.trainable_patterns_for_cfg(pcfg),
                         freeze_all=pcfg.freeze_all)
    if mesh is not None:
        tp.shard_model_(model, mesh)
    calls = LayerCalls(model)
    ctx = (pp.pipeline_parallel(mesh, microbatches) if mesh is not None
           else contextlib.nullcontext())
    t = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    counts = []
    with ctx:
        pp.COUNTS.update(dict.fromkeys(pp.COUNTS, 0))
        with torch.no_grad():
            out = model(t["pixels"], t["mask"], {k: t[k] for k in pstep.TEXT_KEYS})
        counts.append(dict(pp.COUNTS))
        eval_calls = calls.take()
        net = pstep.wrap_ddp(model) if mesh is not None and pstep.ddp_applies() else model
        rec = ReducedGrads(model)
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        rows = torch.from_numpy(np.asarray(assignments)).long()
        orig, pcrit.match_batch = pcrit.match_batch, lambda *a, **k: rows
        pp.COUNTS.update(dict.fromkeys(pp.COUNTS, 0))
        try:
            metrics = pstep.train_step(net, rec, t, gen)
        finally:
            pcrit.match_batch = orig
        counts.append(dict(pp.COUNTS))
    losses = {k: v.item() for k, v in metrics.items() if k != "grad_norm"}
    return (out["pred_logits"], out["pred_boxes"], out["topk_idx"], losses, rec.grads,
            eval_calls, counts[0], counts[1])


def accumulate_run(model, pcfg, batch, assignments, mesh=None, microbatches=None):
    """One accumulation of `train.optim.Optimizer(batch_size_scale=2)` (AdamW
    at lr 1e-2): a call on each half of `batch` (numpy, this rank's), the
    matcher pinned to the half's rows of `assignments`, under
    `pipeline_parallel(mesh, microbatches)` where `mesh` is given (sharded
    first under a model axis): (the gradients that a checkpoint taken
    between the calls holds, those that the update applies), whole."""
    import contextlib

    from ziragroundingdino_torch.config import OptimizerConfig, ScheduleConfig
    from ziragroundingdino_torch.parallel import pp, tp

    poptim.set_trainable(model, poptim.trainable_patterns_for_cfg(pcfg),
                         freeze_all=pcfg.freeze_all)
    if mesh is not None:
        tp.shard_model_(model, mesh)
    opt = poptim.Optimizer(model, OptimizerConfig(lr=1e-2), ScheduleConfig(), batch_size_scale=2)
    applied = {}
    opt.adamw.register_step_pre_hook(lambda *_: applied.update(
        (n, p.tp.full_of(p.grad) if tp.is_sharded(p) else p.grad.clone())
        for n, p in opt.params.items()))
    net = pstep.wrap_ddp(model) if mesh is not None and pstep.ddp_applies() else model
    ctx = (pp.pipeline_parallel(mesh, microbatches) if mesh is not None
           else contextlib.nullcontext())
    orig = pcrit.match_batch
    try:
        with ctx:
            for half in range(2):
                local, rows = local_rows(batch, assignments, half, 2)
                t = {k: torch.from_numpy(np.array(v)) for k, v in local.items()}
                pinned = torch.from_numpy(rows).long()
                pcrit.match_batch = lambda *a, **k: pinned
                pstep.train_step(net, opt, t)
                if half == 0:
                    held = opt.state_dict()["accumulation"]["grads"]
    finally:
        pcrit.match_batch = orig
    return held, applied


def state_digest(model) -> str:
    """A sha256 of `model.state_dict()` (whole weights: every model rank
    calls it at once)."""
    import hashlib

    digest = hashlib.sha256()
    for k, v in sorted(model.state_dict().items()):
        digest.update(k.encode() + v.detach().contiguous().numpy().tobytes())
    return digest.hexdigest()


def job_pp(rank, sizes, microbatches, cases, replicas=None, accumulate=None):
    """Each case's `pipe_run` on this data rank's slice of its global batch
    under `make_mesh(data, model, 1, pipe)` for `sizes` = (data, model,
    pipe), then, for the case labelled `replicas` where given, its
    `replica_run` over the pipe axis and `state_digest`, and, for the case
    `accumulate` where given (one data rank), its `accumulate_run`:
    ({label: pipe_run's result}, this rank's (data, pipe, model)
    coordinates, the replicas' result or None, the accumulation's or
    None)."""
    from ziragroundingdino_torch.parallel import mesh as pmesh

    data, model_size, pipe = sizes
    mesh = pmesh.make_mesh(data, model_size, 1, pipe)
    d = mesh.axes["data"][2]
    out = {}
    for label, pcfg, sd, batch, assignments, seed in cases:
        model = build_model(pcfg, device="cpu", dtype="float32")
        model.load_state_dict(sd)
        local, rows = local_rows(batch, assignments, d, data)
        out[label] = pipe_run(model, pcfg, local, rows, seed, mesh, microbatches)
    rep = None
    if replicas is not None:
        _, pcfg, sd, batch, assignments, _ = next(c for c in cases if c[0] == replicas)
        model = build_model(pcfg, device="cpu", dtype="float32")
        model.load_state_dict(sd)
        local, rows = local_rows(batch, assignments, d, data)
        rep = replica_run(model, pcfg, local, [rows], mesh, axis="pipe",
                          microbatches=microbatches) + (state_digest(model),)
    acc = None
    if accumulate is not None:
        _, pcfg, sd, batch, assignments, _ = accumulate
        model = build_model(pcfg, device="cpu", dtype="float32")
        model.load_state_dict(sd)
        acc = accumulate_run(model, pcfg, batch, assignments, mesh, microbatches)
    coords = (d, mesh.axes["pipe"][2], mesh.axes["model"][2])
    return out, coords, rep, acc
