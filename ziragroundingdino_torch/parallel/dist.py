"""Collectives over `torch.distributed`, one process per card (or several
processes sharing one): the port of the JAX package's `parallel/multihost.py`
(reference: detectron2 `launch` + DDP + NCCL, `train_net.py:246,343-350`,
`util/misc.py:577-635`) and the hand-written side of what GSPMD inserts for
the JAX package's `model` and `seq` mesh axes.

`torchrun --nproc-per-node N` starts the processes and sets `RANK`,
`WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR` and `MASTER_PORT`;
`init_from_env` reads them. `parallel.mesh.make_mesh` lays the processes out
as a `data x pipe x seq x model` mesh and registers it here (`set_mesh`; one mesh
a process, as the default process group is one a process, so that the
model's global-batch sums need no mesh passed down to them; `destroy`
clears it); each collective then reduces over one axis of it, named by
`axis`:

  * "data": the ranks that hold other images. Under `pjit` the JAX package
    computes the global batch's program; here each data rank computes its
    slice of every global batch, and the few places where the model couples
    the images of a batch take their sums over the data axis alone
    (`all_reduce_sum`, `global_divisor`, `mean_over_ranks`), because the
    model and seq ranks of one replica hold the same images;
  * "pipe": the ranks that hold the stages of one pipeline over the
    encoder's layers (`parallel/pp.py`);
  * "model": the ranks that hold the shards of one tensor-parallel weight
    (`parallel/tp.py`);
  * "seq": the ranks that hold the chunks of one image's encoder tokens
    (`parallel/sp.py`);
  * "grad": data x seq, the ranks whose gradients DDP averages.

Without a mesh the data axis (and "grad") is every process of the group and
the others have one rank. With no process group every function is the
one-process identity: a run without `--mesh` computes bitwise what it did
before.

Autograd pairs, each with its true adjoint where the name says so:
`all_reduce_sum` (all-reduce both ways) and `all_gather` (all-gather
forward, reduce-scatter backward) treat the ranks' losses as one sum; the
Megatron pairs of `parallel/tp.py` (`copy_to`, `reduce_from`, `gather_from`,
`scatter_to`) treat every rank's loss as the same loss. All of them are
written with `all_reduce`, `all_gather`, `reduce_scatter` and `broadcast`.
Gloo is the backend of ranks that share one card (NCCL refuses two ranks on
one device). On an H100 with PyTorch 2.11 (CUDA 12.8), gloo took on CUDA
tensors, in f32 and bf16, all_reduce (sum and max), all_gather, broadcast,
all_gather_into_tensor, reduce_scatter, reduce_scatter_tensor and
all_to_all_single; a `send` / `recv` pair aborted the process (gloo:
"writev: Bad address"), so a pipeline stage's transfer is a `broadcast`
in the group of the two neighbouring stages (`parallel/pp.py`). `chip_smoke.py` phase 13 probes the collectives the
port uses (`PORT_COLLECTIVES` there) before it runs the mesh.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Tuple, Union

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
    """Global rank 0: data, seq and model rank 0 (`parallel.mesh`'s layout),
    the rank that writes checkpoints, reports and metrics."""
    return process_index() == 0


# the mesh of `parallel.mesh.make_mesh`: an object with `axes`, {axis name:
# (process group or None for the default group, size, rank in the axis)}
_MESH = None


def set_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def current_mesh():
    return _MESH


def axis(name: str) -> Tuple[Optional[Any], int, int]:
    """(group, size, this process's rank in it) of a mesh axis: "data",
    "pipe", "model", "seq" or "grad" (data x seq). Without a mesh "data" and
    "grad" are every process, the others this one alone."""
    if _MESH is not None:
        return _MESH.axes[name]
    if name in ("data", "grad"):
        return None, process_count(), process_index()
    return None, 1, 0


def data_size() -> int:
    return axis("data")[1]


def data_rank() -> int:
    return axis("data")[2]


def local_batch_size(global_batch_size: int) -> int:
    """This process's slice of the global batch, which must divide evenly
    over the data axis (the per-GPU batch of the reference's DDP setup)."""
    n = data_size()
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by {n} processes")
    return global_batch_size // n


def shard_indices_for_process(n_items: int, seed: int, epoch: int = 0, shuffle: bool = True,
                              drop_last: bool = True) -> np.ndarray:
    """Rank-strided index shard, torch `DistributedSampler`'s semantics: the
    same seeded permutation on every process, then a stride of the data
    axis's size from this data rank; the tail dropped, or padded by
    wrapping. Index for index the JAX package's (`multihost.py:47-80`). The
    train loader shards otherwise (each data rank takes its contiguous slice
    of every global batch, `data/loader.py`); this is for epoch-style sweeps
    over a split."""
    rng = np.random.RandomState((seed * 1_000_003 + epoch) % (2**31 - 1))
    order = rng.permutation(n_items) if shuffle else np.arange(n_items)
    n, r = data_size(), data_rank()
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
    set_mesh(None)
    if is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    """Every process waits for the others (`util/misc.py:632`)."""
    if is_initialized():
        dist.barrier()


def gather_cat(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """The axis's ranks' equal-shaped `x` concatenated along `dim` in rank
    order (no autograd)."""
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


def reduced(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A contiguous copy of `x` all-reduced over `group` (no autograd)."""
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over an axis's ranks whose gradient is the sum over those ranks of
    the incoming gradients (its true adjoint): with every rank's loss a
    function of the sum, the ranks' gradients then add up to the gradient
    of the sum of their losses."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return reduced(x, group)

    @staticmethod
    def backward(ctx, grad):
        return reduced(grad, ctx.group), None


def reduce_scatter_cat(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """This rank's slice along `dim` of the sum of the axis's ranks' `x`, the
    slices equal and in rank order (`gather_cat`'s adjoint; no autograd)."""
    parts = [c.contiguous() for c in x.chunk(size, dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out


class _AllGather(torch.autograd.Function):
    """All-gather along `dim` forward; its true adjoint, a reduce-scatter,
    backward."""

    @staticmethod
    def forward(ctx, x, dim, group, size):
        ctx.args = dim, group, size
        return gather_cat(x, dim, group, size)

    @staticmethod
    def backward(ctx, grad):
        dim, group, size = ctx.args
        return reduce_scatter_cat(grad, dim, group, size), None, None, None


def all_reduce_sum(x: torch.Tensor, axis_name: str = "data") -> torch.Tensor:
    """The sum of `x` over the ranks of a mesh axis (the data axis unless
    named), differentiable; `x` itself on an axis of one rank."""
    group, size, _ = axis(axis_name)
    if size == 1:
        return x
    return _AllReduceSum.apply(x, group)


def all_gather(x: torch.Tensor, dim: int, axis_name: str) -> torch.Tensor:
    """The axis's ranks' `x` concatenated along `dim` in rank order; the
    backward reduce-scatters (`_AllGather`)."""
    group, size, _ = axis(axis_name)
    if size == 1:
        return x
    return _AllGather.apply(x, dim, group, size)


def global_divisor(count: torch.Tensor) -> torch.Tensor:
    """The divisor of a rank's share of a mean over the global batch: with
    `count` this rank's number of terms, max(sum over the data ranks, 1) /
    the data axis's size. A rank's sum over its terms divided by it, summed
    over the data ranks, is their count times the global mean, so DDP's
    mean over the ranks gives the global mean's gradient (the reference's
    `num_boxes`, `criterion.py:238-240`, clamped as the JAX package clamps
    it, before the division). `count.clamp(min=1)` on one data rank."""
    group, size, _ = axis("data")
    if size == 1:
        return count.clamp(min=1.0)
    return reduced(count.detach(), group).clamp(min=1.0) / size


def mean_over_ranks(values: dict) -> dict:
    """{name: scalar tensor} averaged over the data ranks in one all-reduce:
    the global batch's losses from the ranks' shares. Unchanged on one data
    rank."""
    group, size, _ = axis("data")
    if size == 1 or not values:
        return values
    names = sorted(values)
    stacked = reduced(torch.stack([values[k].detach().float() for k in names]), group)
    stacked /= size
    return dict(zip(names, stacked.unbind()))


@torch.no_grad()
def mean_over_ranks_(tensors, axis_name: str = "grad") -> None:
    """Each tensor set to its mean over the ranks of an axis (DDP's, data x
    seq, unless named), in place."""
    group, size, _ = axis(axis_name)
    if size == 1:
        return
    for t in tensors:
        dist.all_reduce(t, group=group)
        t /= size


def _leader(group) -> int:
    """The global rank of a group's rank 0."""
    return 0 if group is None else dist.get_global_rank(group, 0)


def gather_to_rank0(obj: Any) -> Optional[List[Any]]:
    """[every data rank's `obj`] in data-rank order on data rank 0 (host
    objects, pickled), None on the others; `[obj]` on one data rank."""
    group, size, rank = axis("data")
    if size == 1:
        return [obj]
    out = [None] * size if rank == 0 else None
    dist.gather_object(obj, out, dst=_leader(group), group=group)
    return out


def broadcast_object(obj: Any) -> Any:
    """Data rank 0's `obj` on every data rank."""
    group, size, _ = axis("data")
    if size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=_leader(group), group=group)
    return box[0]


@torch.no_grad()
def broadcast_module_(module: torch.nn.Module) -> None:
    """Every parameter and buffer of `module` set to those of rank 0 of its
    gradient axis (data x seq: the ranks that hold the same shards), in
    place."""
    group, size, _ = axis("grad")
    if size == 1:
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=_leader(group), group=group)
