"""Data parallelism over `torch.distributed`, one process per card: the port
of the JAX package's `parallel/multihost.py` (reference: detectron2
`launch` + DDP + NCCL, `train_net.py:246,343-350`, `util/misc.py:577-635`).

`torchrun --nproc-per-node N` starts the processes and sets `RANK`,
`WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR` and `MASTER_PORT`;
`init_from_env` reads them. Under `pjit` the JAX package computes the
global batch's program; here each rank computes its slice of every global
batch, and the few places where the model couples the images of a batch
take their sums over all ranks (`all_reduce_sum`, `global_divisor`), so
that DDP's mean of the ranks' gradients is the gradient of the JAX
package's global-batch loss.

With no process group every function is the one-process identity: a run
without `--mesh` computes bitwise what it did before.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_main_process() -> bool:
    return process_index() == 0


def local_batch_size(global_batch_size: int) -> int:
    """This process's slice of the global batch, which must divide evenly
    (the per-GPU batch of the reference's DDP setup)."""
    n = process_count()
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by {n} processes")
    return global_batch_size // n


def shard_indices_for_process(n_items: int, seed: int, epoch: int = 0, shuffle: bool = True,
                              drop_last: bool = True) -> np.ndarray:
    """Rank-strided index shard, torch `DistributedSampler`'s semantics: the
    same seeded permutation on every process, then a stride of the process
    count from this rank; the tail dropped, or padded by wrapping. Index for
    index the JAX package's (`multihost.py:47-80`). The train loader shards
    otherwise (each process takes its contiguous slice of every global
    batch, `data/loader.py`); this is for epoch-style sweeps over a split."""
    rng = np.random.RandomState((seed * 1_000_003 + epoch) % (2**31 - 1))
    order = rng.permutation(n_items) if shuffle else np.arange(n_items)
    n, r = process_count(), process_index()
    if drop_last:
        order = order[:(n_items // n) * n]
    else:
        pad = (-len(order)) % n
        if pad:
            order = np.concatenate([order, order[:pad]])
    return order[r::n]


def init_from_env(device: Optional[Union[str, torch.device]] = None,
                  backend: Optional[str] = None) -> torch.device:
    """Join the process group that `torchrun` describes in the environment
    and return this rank's device: `device` where given (`"cpu"`, or a card
    that several ranks share), else the card `cuda:{LOCAL_RANK}`, which is
    made current. The backend is NCCL on the card and gloo on the CPU unless
    `backend` names one; nothing falls back to another device or backend.
    A process that is already in a group keeps it."""
    local = int(os.environ.get("LOCAL_RANK", 0))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        device = f"cuda:{local}"
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if not is_initialized():
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    return dev


def destroy() -> None:
    if is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    """Every process waits for the others (`util/misc.py:632`)."""
    if is_initialized():
        dist.barrier()


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose gradient is the sum over the ranks of the
    incoming gradients: with every rank's loss a function of the global sum,
    DDP's mean of the ranks' gradients is then the gradient of the mean of
    their losses."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks, differentiable; `x` itself without a
    process group."""
    if not is_initialized():
        return x
    return _AllReduceSum.apply(x)


def global_divisor(count: torch.Tensor) -> torch.Tensor:
    """The divisor of a rank's share of a mean over the global batch: with
    `count` this rank's number of terms, max(sum over the ranks, 1) / the
    process count. A rank's sum over its terms divided by it, summed over
    the ranks, is the process count times the global mean, so DDP's mean
    over the ranks gives the global mean's gradient (the reference's
    `num_boxes`, `criterion.py:238-240`, clamped as the JAX package clamps
    it, before the division). `count.clamp(min=1)` without a process
    group."""
    if not is_initialized():
        return count.clamp(min=1.0)
    total = count.detach().clone()
    dist.all_reduce(total)
    return total.clamp(min=1.0) / process_count()


def mean_over_ranks(values: dict) -> dict:
    """{name: scalar tensor} averaged over the ranks in one all-reduce: the
    global batch's losses from the ranks' shares. Unchanged without a
    process group."""
    if not is_initialized() or not values:
        return values
    names = sorted(values)
    stacked = torch.stack([values[k].detach().float() for k in names])
    dist.all_reduce(stacked)
    stacked /= process_count()
    return dict(zip(names, stacked.unbind()))


@torch.no_grad()
def mean_over_ranks_(tensors) -> None:
    """Each tensor set to its mean over the ranks, in place."""
    if not is_initialized():
        return
    for t in tensors:
        dist.all_reduce(t)
        t /= process_count()


def gather_to_rank0(obj: Any) -> Optional[List[Any]]:
    """[every rank's `obj`] in rank order on rank 0 (host objects, pickled),
    None on the others; `[obj]` without a process group."""
    if not is_initialized():
        return [obj]
    out = [None] * process_count() if is_main_process() else None
    dist.gather_object(obj, out, dst=0)
    return out


def broadcast_object(obj: Any) -> Any:
    """Rank 0's `obj` on every rank."""
    if not is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


@torch.no_grad()
def broadcast_module_(module: torch.nn.Module) -> None:
    """Every parameter and buffer of `module` set to rank 0's, in place."""
    if not is_initialized():
        return
    for t in module.state_dict().values():
        dist.broadcast(t, src=0)
