"""The device mesh, the port of the JAX package's `parallel/mesh.py::make_mesh`
(`:25-50`). The port runs the reference's one strategy, data parallelism
(DDP, `train_net.py:246`): a mesh is its `data` axis over the processes
that `torchrun` started, one card each. The JAX package's other axes,
`model` (tensor parallel), `seq` (sequence parallel) and `pipe`, are not
ported (ROADMAP Queue 1 item 10), nor its `_TP_RULES` / `param_sharding`.
"""

from __future__ import annotations

import argparse
import os
from typing import Tuple

import torch.distributed as tdist

from ziragroundingdino_torch.parallel import dist

NOT_PORTED = ("tensor, sequence and pipeline parallelism (the mesh's model, seq and pipe "
              "axes) are not ported yet: ROADMAP Queue 1 item 10")


def parse_mesh(spec: str) -> Tuple[int, int, int]:
    """'data[,model[,seq]]' -> (data, model, seq), as the JAX package's
    `train_odinw` reads its --mesh."""
    sizes = [int(x) for x in spec.split(",")]
    if not 1 <= len(sizes) <= 3 or min(sizes) < 1:
        raise ValueError(f"--mesh {spec!r}: want data[,model[,seq]], each at least 1")
    sizes += [1] * (3 - len(sizes))
    return sizes[0], sizes[1], sizes[2]


def make_mesh(data: int = -1, model: int = 1, seq: int = 1, pipe: int = 1):
    """The `data` axis over every process of the group (`data=-1`: all of
    them), checked against the processes there are; returns the group that
    the axis reduces over (the default group). `model`, `seq` or `pipe`
    above 1 raise NotImplementedError."""
    if max(model, seq, pipe) > 1:
        raise NotImplementedError(f"mesh data={data} model={model} seq={seq} pipe={pipe}: "
                                  + NOT_PORTED)
    n = dist.process_count()
    if data == -1:
        data = n
    if data != n:
        raise ValueError(
            f"mesh data={data} needs {data} processes but this one is 1 of {n}"
            f"{'' if dist.is_initialized() else ' (no process group)'}: launch it as "
            f"`torchrun --nproc-per-node {data} -m ziragroundingdino_torch.scripts.<script> "
            f"--mesh {data} ...`, one process per card")
    return tdist.group.WORLD if dist.is_initialized() else None


def add_mesh_args(ap: argparse.ArgumentParser, mesh_help: str) -> None:
    ap.add_argument("--mesh", default=None, help=mesh_help)


def init_mesh(args: argparse.Namespace, batch_size: int):
    """Join the data-parallel group that --mesh names, check its size and the
    batch against it, and build the kernels once (on rank 0, the others
    waiting) before any rank loads them. Returns (device, whether this call
    joined the group); (args.device, False) without --mesh."""
    if not args.mesh:
        return args.device, False
    try:
        data, model, seq = parse_mesh(args.mesh)
        if max(model, seq) > 1:
            raise NotImplementedError(NOT_PORTED)
    except (ValueError, NotImplementedError) as e:
        raise SystemExit(f"--mesh {args.mesh}: {e}")
    if "WORLD_SIZE" not in os.environ:
        raise SystemExit(f"--mesh {args.mesh} needs {data} processes: launch it as `torchrun "
                         f"--nproc-per-node {data} -m ziragroundingdino_torch.scripts.<script> "
                         f"--mesh {args.mesh} ...`")
    if batch_size % data:
        raise SystemExit(f"--batch-size {batch_size} must be divisible by the data axis {data}")
    joined = not dist.is_initialized()
    device = dist.init_from_env(args.device)
    try:
        make_mesh(data=data)
    except ValueError as e:
        if joined:
            dist.destroy()
        raise SystemExit(f"--mesh {args.mesh}: {e}")
    if device.type == "cuda":
        from ziragroundingdino_torch.ops import cuda_build

        if dist.is_main_process():
            cuda_build.build_all()
        dist.barrier()
    return device, joined
