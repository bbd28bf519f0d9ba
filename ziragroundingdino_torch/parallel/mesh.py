"""The device mesh, the port of the JAX package's `parallel/mesh.py`
(`:25-103`). A mesh lays the processes that `torchrun` started out as
`data x pipe x seq x model`, `model` innermost as in JAX (`:46-50`): the
process of global rank r = ((d * pipe + p) * seq + s) * model + m has
coordinates (d, p, s, m), so every mesh with one pipe stage keeps the
ranks of a `data x seq x model` one. Every axis has one process group per
line of ranks along it (`torch.distributed.new_group`, created by every
rank in one order). `make_mesh` registers the mesh with `parallel.dist`,
whose collectives then reduce over its axes.

  * `data`: batch sharding, DDP (the reference's only strategy,
    `train_net.py:246`);
  * `pipe`: pipeline parallelism over the encoder's layers
    (`parallel/pp.py`); besides the pipe line, each pair of neighbouring
    stages of it has a group of its two ranks (`Mesh.boundaries`). As in
    JAX, no driver flag reaches it: a caller enters
    `pp.pipeline_parallel(mesh)` (`train_odinw --mesh` takes
    data[,model[,seq]], as the JAX driver's);
  * `model`: tensor parallelism, JAX's `_TP_RULES` applied to the port's
    parameters (`tp_targets`, `parallel/tp.py`);
  * `seq`: sequence parallelism over the encoder's tokens
    (`parallel/sp.py`).
"""

from __future__ import annotations

import argparse
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch.distributed as tdist

from ziragroundingdino_torch.parallel import dist

# param-path regexes -> the JAX kernel's sharded dimension, copied rule for
# rule from the JAX package (`parallel/mesh.py:56-65`; P(None, "model") is
# dimension 1 of a [in, out] kernel, output features: column-parallel;
# P("model", None) dimension 0, input features: row-parallel). Matched with
# `re.search` against the JAX path, as there: `output_dense/kernel$` also
# matches BERT's `attention_output_dense`.
_TP_RULES = (
    (r"linear1/kernel$", 1),
    (r"linear2/kernel$", 0),
    (r"intermediate_dense/kernel$", 1),
    (r"output_dense/kernel$", 0),
    (r"in_proj_kernel$", 1),
    (r"qkv/kernel$", 1),
    (r"mlp_fc1/kernel$", 1),
    (r"mlp_fc2/kernel$", 0),
)


@dataclass
class Mesh:
    """Axis sizes, this process's coordinates, and `axes`: {"data",
    "pipe", "model", "seq", "grad" (data x seq): (process group, size,
    rank in it)}; a group of None is the default group, and an axis of one
    rank has none. `boundaries[b]`, for each pair of neighbouring stages
    (b, b + 1) of this process's pipe line: (the pair's process group, the
    global rank of stage b, that of stage b + 1) where this process is one
    of the two, else None."""

    data: int = 1
    model: int = 1
    seq: int = 1
    pipe: int = 1
    axes: Dict[str, tuple] = field(default_factory=dict)
    boundaries: List[Optional[tuple]] = field(default_factory=list)


def parse_mesh(spec: str) -> Tuple[int, int, int]:
    """'data[,model[,seq]]' -> (data, model, seq), as the JAX package's
    `train_odinw` reads its --mesh."""
    sizes = [int(x) for x in spec.split(",")]
    if not 1 <= len(sizes) <= 3 or min(sizes) < 1:
        raise ValueError(f"--mesh {spec!r}: want data[,model[,seq]], each at least 1")
    sizes += [1] * (3 - len(sizes))
    return sizes[0], sizes[1], sizes[2]


def _launch(data: int, model: int, seq: int, pipe: int = 1) -> str:
    n = data * model * seq * pipe
    if pipe > 1:  # no driver flag takes the pipe axis, as in JAX
        return (f"torchrun --nproc-per-node {n} <script>` whose processes call "
                f"`make_mesh(data={data}, model={model}, seq={seq}, pipe={pipe})")
    spec = f"{data},{model},{seq}" if model * seq > 1 else f"{data}"
    return (f"torchrun --nproc-per-node {n} -m ziragroundingdino_torch.scripts.<script> "
            f"--mesh {spec} ...")


def make_mesh(data: int = -1, model: int = 1, seq: int = 1, pipe: int = 1) -> Mesh:
    """The `data x pipe x seq x model` mesh over every process of the group
    (`data=-1`: the processes that `model * seq * pipe` leaves), checked
    against the processes there are, with one process group per line of
    each axis of more than one rank and one per pair of neighbouring pipe
    stages; registered with `parallel.dist`. The "grad" axis (DDP's, data x
    seq) and the "model" lines are taken at a fixed pipe coordinate."""
    n = dist.process_count()
    fixed = model * seq * pipe
    if data == -1:
        if n % fixed:
            raise ValueError(f"{n} processes not divisible by model*seq*pipe={fixed}")
        data = n // fixed
    if data * fixed != n:
        raise ValueError(
            f"mesh data={data} model={model} seq={seq} pipe={pipe} needs {data * fixed} "
            f"processes but this one is 1 of {n}"
            f"{'' if dist.is_initialized() else ' (no process group)'}: "
            f"launch it as `{_launch(data, model, seq, pipe)}`")
    r = dist.process_index()
    d, p = r // (pipe * seq * model), r // (seq * model) % pipe
    s, m = r // model % seq, r % model

    def rank_of(d_, p_, s_, m_):
        return ((d_ * pipe + p_) * seq + s_) * model + m_

    def lines_along(size, at):
        """Every line of the axis whose coordinate `at(i, rest)` places, one
        per value of the other coordinates."""
        rest = [(d_, p_, s_, m_) for d_ in range(data) for p_ in range(pipe)
                for s_ in range(seq) for m_ in range(model)]
        out = []
        for c in rest:
            line = [rank_of(*at(i, c)) for i in range(size)]
            if line not in out:
                out.append(line)
        return out

    lines = {  # axis: (its size, this rank's coordinate, every line's ranks)
        "data": (data, d, lines_along(data, lambda i, c: (i, c[1], c[2], c[3]))),
        "pipe": (pipe, p, lines_along(pipe, lambda i, c: (c[0], i, c[2], c[3]))),
        "seq": (seq, s, lines_along(seq, lambda i, c: (c[0], c[1], i, c[3]))),
        "model": (model, m, lines_along(model, lambda i, c: (c[0], c[1], c[2], i))),
        "grad": (data * seq, d * seq + s,
                 lines_along(data * seq, lambda i, c: (i // seq, c[1], i % seq, c[3]))),
    }
    axes = {}
    for name, (size, coord, all_lines) in lines.items():
        if name == "grad" and seq == 1:
            axes[name] = axes["data"]
        elif size == 1:
            axes[name] = (None, 1, 0)
        elif size == n and name != "grad":  # the whole group
            axes[name] = (None, n, coord)
        else:
            # every rank creates every group, in one order; DDP's own groups
            # ("grad"), so that its bucket reductions, issued as the backward
            # goes, never share a group with the seq axis's
            group = None
            for ranks in all_lines:
                g = tdist.new_group(ranks)
                if r in ranks:
                    group = g
            axes[name] = (group, size, coord)
    # a group per pair of neighbouring stages of each pipe line, so that the
    # pipeline's transfers between stages wait on those two ranks alone;
    # with two stages the pair is the pipe line
    boundaries: List[Optional[tuple]] = [None] * (pipe - 1)
    for b in range(pipe - 1):
        for line in lines["pipe"][2]:
            pair = line[b:b + 2]
            g = axes["pipe"][0] if pipe == 2 else tdist.new_group(pair)
            if r in pair:
                boundaries[b] = (g, pair[0], pair[1])
    mesh = Mesh(data=data, model=model, seq=seq, pipe=pipe, axes=axes, boundaries=boundaries)
    dist.set_mesh(mesh)
    return mesh


def tp_targets(model, mesh) -> Dict[str, int]:
    """{parameter name: the torch weight's sharded dimension (0: output
    features, column-parallel; 1: input features, row-parallel)} of the
    parameters that the JAX package's `param_sharding` shards on a mesh of
    `mesh.model` model ranks: each name mapped to its JAX path through the
    weight bridge (`weights.param_path`), matched against `_TP_RULES`, and kept
    where the sharded dimension divides evenly (`:79-88` there). Empty when
    the model axis has one rank."""
    from ziragroundingdino_torch.weights import param_path

    out: Dict[str, int] = {}
    if mesh.model <= 1:
        return out
    for name, p in model.named_parameters():
        path = param_path(name)
        if path is None:
            continue
        for pat, jax_dim in _TP_RULES:
            if re.search(pat, path):
                dim = 1 - jax_dim  # JAX [in, out] -> torch [out, in]
                if p.shape[dim] % mesh.model == 0:
                    out[name] = dim
                break
    return out


def add_mesh_args(ap: argparse.ArgumentParser, mesh_help: str) -> None:
    ap.add_argument("--mesh", default=None, help=mesh_help)


def init_mesh(args: argparse.Namespace, batch_size: int, data_only: bool = False):
    """Join the process group that --mesh names, check its sizes against the
    processes there are and the batch against the data axis, build the mesh,
    and build the kernels once (on rank 0, the others waiting) before any
    rank loads them. `data_only`: a driver that takes the data axis alone
    (`eval_coco`, as in JAX). Returns (device, the mesh or None without
    --mesh, whether this call joined the group)."""
    if not args.mesh:
        return args.device, None, False
    try:
        data, model, seq = parse_mesh(args.mesh)
        if data_only and max(model, seq) > 1:
            raise ValueError("this script's --mesh is the data axis alone, as the JAX "
                             "package's")
    except ValueError as e:
        raise SystemExit(f"--mesh {args.mesh}: {e}")
    if "WORLD_SIZE" not in os.environ:
        raise SystemExit(f"--mesh {args.mesh} needs {data * model * seq} processes: launch it "
                         f"as `{_launch(data, model, seq)}`")
    if batch_size % data:
        raise SystemExit(f"--batch-size {batch_size} must be divisible by the data axis {data}")
    joined = not dist.is_initialized()
    device = dist.init_from_env(args.device)
    try:
        mesh = make_mesh(data=data, model=model, seq=seq)
    except ValueError as e:
        if joined:
            dist.destroy()
        raise SystemExit(f"--mesh {args.mesh}: {e}")
    if device.type == "cuda":
        from ziragroundingdino_torch.ops import cuda_build

        if dist.is_main_process():
            cuda_build.build_all()
        dist.barrier()
    return device, mesh, joined
