"""The single-task trainer, the port of the JAX package's `train/trainer.py`
(reference `Trainer(SimpleTrainer)`, `train_net.py:53-161`, and its hooks,
`:259-295`): the loop, metric logging to `metrics.jsonl`, checkpoints and
resume, and `fast_dev_run` (`train_net.py:313-317`).

A checkpoint is one `torch.save` file, `<output_dir>/ckpt/step_N.pt`,
holding the step, the model's state dict and `Optimizer.state_dict()`
(AdamW, schedule, EMA); `torch.load(weights_only=True)` reads it. The
`last_checkpoint` marker names the newest one, as detectron2 writes it.
Both are written to a temporary name and renamed, so a run cut while
writing leaves the previous checkpoint in force.

Randomness per iteration: iteration `it` draws its dropout from a fresh
generator on the model's device, seeded from (`cfg.seed`, `it`) (the JAX
package's `fold_in(rng, it)`), so a run resumed at `it` draws what an
uninterrupted run draws there without saving a generator's state.

Timing in `metrics.jsonl`, per log period: `data_time` is the host's wait
on the loader; `step_time` the steps' time, the device synchronised once
at the log boundary so that it counts the device's work, not the enqueue.

Under data parallelism (a process group, `parallel.dist`) each rank runs
the loop on its slice of every global batch through `train.step.wrap_ddp`;
data rank r > 0 draws its own dropout (seeded from (`cfg.seed`, `it`, r));
the model and seq ranks of one data rank draw alike (`parallel/tp.py`,
`parallel/sp.py`). Rank 0 alone prints, writes `metrics.jsonl` and the
checkpoints (every rank takes part in the state dict: tensor-parallel
shards are gathered), and every rank waits for the write and resumes from
the same file. `eval_fn`, called
every `cfg.eval_period` iterations, runs on every rank (the eval is
sharded too), as the JAX package's eval hook (`trainer.py:151-152`).
"""

from __future__ import annotations

import functools
import json
import logging
import os
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ziragroundingdino_torch.config import TrainConfig
from ziragroundingdino_torch.models.groundingdino import GroundingDINO
from ziragroundingdino_torch.parallel import dist
from ziragroundingdino_torch.train.optim import Optimizer
from ziragroundingdino_torch.train.step import ddp_applies, train_step, wrap_ddp
from ziragroundingdino_torch.utils import profiling
from ziragroundingdino_torch.utils.events import CommonMetricPrinter

logger = logging.getLogger("ziragroundingdino_torch")


class JSONLWriter:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.f = open(path, "a")

    def write(self, step: int, metrics: Dict[str, float]):
        rec = {"iteration": step}
        rec.update({k: float(v) for k, v in metrics.items()})
        self.f.write(json.dumps(rec) + "\n")
        self.f.flush()

    def close(self):
        self.f.close()


def save_atomically(obj, path: str) -> None:
    """`torch.save` to `path` through a temporary file and a rename."""
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(ckpt_dir: str, model: GroundingDINO, optimizer: Optimizer, step: int) -> str:
    """Write `step_N.pt` and the marker; under data parallelism every rank
    calls it, rank 0 writes, and all return once the file is there."""
    name = f"step_{step}.pt"
    path = os.path.join(ckpt_dir, name)
    payload = {"step": step, "model": model.state_dict(), "optimizer": optimizer.state_dict()}
    if dist.is_main_process():
        os.makedirs(ckpt_dir, exist_ok=True)
        save_atomically(payload, path)
        marker = os.path.join(ckpt_dir, "last_checkpoint")
        with open(marker + ".tmp", "w") as f:
            f.write(name)
        os.replace(marker + ".tmp", marker)
    dist.barrier()
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    marker = os.path.join(ckpt_dir, "last_checkpoint")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        return os.path.join(ckpt_dir, f.read().strip())


def checkpoint_step(path: str) -> int:
    """N of `.../step_N.pt`."""
    return int(os.path.basename(path)[len("step_"):-len(".pt")])


def restore_checkpoint(path: str, device: Optional[torch.device] = None) -> dict:
    return torch.load(path, map_location=device, weights_only=True)


def iteration_generator(seed: int, it: int, device: torch.device,
                        rank: int = 0) -> torch.Generator:
    """The generator of iteration `it` on data-parallel rank `rank`, a
    function of (seed, it, rank) alone; rank 0's is the one-process run's,
    and no two data ranks share one (the model and seq ranks of one data
    rank do: they draw the masks of one replica)."""
    entropy = [seed, it] if rank == 0 else [seed, it, rank]
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) & (2**63 - 1))


class Trainer:
    """The loop of one task: `step_fn(model, optimizer, batch, generator)`
    (`train.step.train_step`) over the loader's numpy batches, moved to the
    model's device. Under a process group the step gets the model wrapped
    by `train.step.wrap_ddp` (where it has trainable parameters), built
    here, after `set_trainable`, and dropped by `close()`."""

    def __init__(
        self,
        model: GroundingDINO,
        optimizer: Optimizer,
        loader: Iterable[Dict[str, np.ndarray]],
        cfg: TrainConfig,
        step_fn: Optional[Callable] = None,  # default: train.step.train_step
        matcher_impl: str = "lsap",  # the default step's matcher
        eval_fn: Optional[Callable] = None,  # (model) -> metrics, every cfg.eval_period
    ):
        self.model = model
        self.optimizer = optimizer
        self.loader = iter(loader)
        self.cfg = cfg
        self.step_fn = step_fn or functools.partial(train_step, matcher_impl=matcher_impl)
        self.device = next(model.parameters()).device
        self.net = model
        if ddp_applies() and optimizer.params:
            self.net = wrap_ddp(model, matcher_impl)
        self.eval_fn = eval_fn
        self.eval_results: list = []  # (iteration, eval_fn's metrics)

    def close(self) -> None:
        """Drop the DDP wrapper, whose hooks would otherwise reduce the
        gradients of a later backward through the same parameters."""
        self.net = self.model

    def train(self, start_iter: int = 0, max_iter: Optional[int] = None) -> None:
        cfg = self.cfg
        max_iter = max_iter or cfg.max_iter
        if cfg.fast_dev_run:
            max_iter = min(max_iter, 20)
        writer = printer = None
        if dist.is_main_process():
            writer = JSONLWriter(os.path.join(cfg.output_dir, "metrics.jsonl"))
            printer = CommonMetricPrinter(max_iter)
        try:
            self._loop(start_iter, max_iter, writer, printer)
        finally:
            if writer is not None:
                writer.close()

    def _loop(self, start_iter: int, max_iter: int, writer: Optional[JSONLWriter],
              printer: Optional[CommonMetricPrinter]) -> None:
        cfg = self.cfg
        rank = dist.data_rank()  # the model and seq ranks of a replica draw alike
        t_data = t_step = 0.0
        t0 = time.perf_counter()
        for it in range(start_iter, max_iter):
            batch = {k: torch.as_tensor(v).to(self.device)
                     for k, v in next(self.loader).items() if k != "real_count"}
            t1 = time.perf_counter()
            metrics = self.step_fn(self.net, self.optimizer, batch,
                                   iteration_generator(cfg.seed, it, self.device, rank))
            log = (it + 1) % cfg.log_period == 0 or it + 1 == max_iter
            if log:  # the period's steps end on the device, not at their enqueue
                profiling.synchronize(self.device)
            t_data += t1 - t0
            t_step += time.perf_counter() - t1
            if log:
                line = {k: float(v) for k, v in metrics.items()}
                line["data_time"] = t_data
                line["step_time"] = t_step
                t_data = t_step = 0.0
                if writer is not None:
                    writer.write(it + 1, line)
                    printer.write(it + 1, line)
            if (it + 1) % cfg.checkpoint_period == 0 or it + 1 == max_iter:
                save_checkpoint(os.path.join(cfg.output_dir, "ckpt"), self.model,
                                self.optimizer, it + 1)
            if self.eval_fn is not None and (it + 1) % cfg.eval_period == 0:
                self.eval_results.append((it + 1, self.eval_fn(self.model)))
            t0 = time.perf_counter()

    def resume_or_load(self) -> int:
        """Load the newest checkpoint of output_dir/ckpt into the model and
        the optimizer, if there is one, and return the iteration to start
        at (`train_net.py:298-305`)."""
        path = latest_checkpoint(os.path.join(self.cfg.output_dir, "ckpt"))
        if path is None:
            return 0
        ckpt = restore_checkpoint(path, self.device)
        self.model.load_state_dict(ckpt["model"])
        self.optimizer.load_state_dict(ckpt["optimizer"])
        return int(ckpt["step"])
