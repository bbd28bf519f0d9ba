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
