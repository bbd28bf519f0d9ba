"""Tensor parallelism over the mesh's `model` axis. The JAX package has no
module for it: it places the parameters that `_TP_RULES` names with
`param_sharding` and GSPMD partitions the matmuls. Here `shard_model_`
swaps each target of `parallel.mesh.tp_targets` in place for a layer that
holds the rank's shard of its weight, along JAX's dimension, and issues the
collectives itself:

  * `ColumnParallelLinear` (JAX's P(None, "model"): `linear1`,
    `intermediate_dense`, `mlp_fc1`, Swin's `qkv`) holds the rank's slice
    of the output features, contiguous as in JAX. Where its row-parallel
    partner (`linear2`, `output_dense`, `mlp_fc2`) is a target too, the
    sharded output goes on to it through the elementwise activation between
    them with no gather; else (`qkv`) the output is gathered;
  * `RowParallelLinear` (P("model", None)) holds the rank's slice of the
    input features and all-reduces its partial output. Where its input is
    replicated (BERT's `attention_output_dense`, which JAX's
    `output_dense/kernel$` matches too), it takes the rank's slice of it
    first;
  * `ParallelMultiHeadAttention`: `in_proj` is column-parallel with its
    q, k and v outputs gathered. The split is head-aligned, not JAX's
    contiguous split of the 3E rows (which crosses the q/k/v boundaries,
    while q, k and v project different inputs): rank m holds rows
    [m E / M, (m + 1) E / M) of each of the q, k and v blocks. Its element
    count is JAX's, and the checkpoint's layout stays the reference's.

Biases stay whole and replicated, as in JAX.

The gradient convention is Megatron's: every model rank computes the same
loss, and a replicated tensor holds its full gradient on every model rank.
Into a column-parallel layer the input passes by `copy_to` (identity
forward, all-reduce backward); out of a row-parallel layer by `reduce_from`
(all-reduce forward, identity backward); a gathered output by `gather_from`
(all-gather forward, the rank's slice backward); a replicated input or
bias that a layer uses a slice of by `scatter_to` (the slice forward,
all-gather backward). Replicated parameters then get the full gradient on
every model rank, with no reduction over the model group, and each shard
the gradient of its slice. The model ranks' gradients of a replicated
parameter are equal in exact arithmetic but not bitwise (the MSDA
backward's float atomics add in no fixed order), and each rank would
apply its own AdamW update to its copy: `mean_replicated_grads_` averages
them over the model axis before every optimizer step, so the copies stay
one. The optimizer counts each shard once in the global norm
(`train.optim.clip_by_global_norm_`).

A sharded layer's `state_dict` holds the whole weight (gathered over the
model axis, so every model rank calls `model.state_dict()` at once) and
`load_state_dict` takes the whole weight and keeps the rank's slice:
checkpoints, `state_final.pt`, `rep_merge` and `load_model` see whole
tensors in the reference's keys and shapes.
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch
import torch.nn.functional as F
from torch import nn

from ziragroundingdino_torch.models.layers import Linear, MultiHeadAttention
from ziragroundingdino_torch.parallel import dist

# (column target's key suffix, its row-parallel partner's): a pair needs no
# gather between its layers
PAIRS = ((".linear1.weight", ".linear2.weight"),
         (".intermediate.dense.weight", ".output.dense.weight"),
         (".mlp.fc1.weight", ".mlp.fc2.weight"))


class TPShard:
    """Where a weight's local shard lies: `dim` of the torch weight split in
    `size` contiguous slices over the model axis, or, for `in_proj`
    (`qkv=True`), each of its three row blocks split so."""

    def __init__(self, full_shape, dim: int, qkv: bool = False):
        self.group, self.size, self.rank = dist.axis("model")
        self.full_shape, self.dim, self.qkv = tuple(full_shape), dim, qkv

    def local_of(self, full: torch.Tensor) -> torch.Tensor:
        if self.qkv:
            e = full.shape[0] // 3
            rows = full.reshape(3, e, -1).chunk(self.size, 1)[self.rank]
            return rows.reshape(-1, full.shape[1]).clone()
        return full.chunk(self.size, self.dim)[self.rank].clone()

    @torch.no_grad()
    def full_of(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every model rank's `local` (a collective)."""
        if self.qkv:
            e = local.shape[0] // 3
            parts = dist.gather_cat(local.reshape(3, e, -1), 1, self.group, self.size)
            return parts.reshape(-1, local.shape[1])
        return dist.gather_cat(local, self.dim, self.group, self.size)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return dist.reduced(grad, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return dist.reduced(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, rank):
        ctx.args = x.shape[-1], rank
        return dist.gather_cat(x, -1, group, size)

    @staticmethod
    def backward(ctx, grad):
        n, rank = ctx.args
        return grad.narrow(-1, rank * n, n), None, None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, rank):
        ctx.args = group, size
        n = x.shape[-1] // size
        return x.narrow(-1, rank * n, n).contiguous()

    @staticmethod
    def backward(ctx, grad):
        group, size = ctx.args
        return dist.gather_cat(grad, -1, group, size), None, None, None


def copy_to(x, shard: TPShard):
    return _CopyTo.apply(x, shard.group)


def reduce_from(x, shard: TPShard):
    return _ReduceFrom.apply(x, shard.group)


def gather_from(x, shard: TPShard):
    """Every model rank's last-dimension slice of `x`, concatenated."""
    return _GatherFrom.apply(x, shard.group, shard.size, shard.rank)


def scatter_to(x, shard: TPShard):
    """The rank's slice of the last dimension of a replicated `x`."""
    return _ScatterTo.apply(x, shard.group, shard.size, shard.rank)


class _ShardedState:
    """A module whose parameter `_tp_name` holds the rank's shard: the
    state dict saves and loads it whole."""

    _tp_name = "weight"

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        super()._save_to_state_dict(destination, prefix, keep_vars)
        p = getattr(self, self._tp_name)
        destination[prefix + self._tp_name] = p.tp.full_of(p.detach())

    def _load_from_state_dict(self, state_dict, prefix, local_metadata, strict, missing_keys,
                              unexpected_keys, error_msgs):
        key = prefix + self._tp_name
        p = getattr(self, self._tp_name)
        whole = state_dict.get(key)
        if whole is None or tuple(whole.shape) != p.tp.full_shape:
            return super()._load_from_state_dict(state_dict, prefix, local_metadata, strict,
                                                 missing_keys, unexpected_keys, error_msgs)
        state_dict[key] = p.tp.local_of(whole)
        try:
            super()._load_from_state_dict(state_dict, prefix, local_metadata, strict,
                                          missing_keys, unexpected_keys, error_msgs)
        finally:
            state_dict[key] = whole


class ColumnParallelLinear(_ShardedState, Linear):
    """`Linear` holding the rank's slice of the output features; see the
    module doc. `gather_output`: whether the output is gathered."""

    gather_output = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype or x.dtype
        shard = self.weight.tp
        w = self.weight.to(cd)
        if self.gather_output:
            y = gather_from(F.linear(copy_to(x, shard).to(cd), w), shard)
            return y if self.bias is None else y + self.bias.to(cd)
        bias = None if self.bias is None else scatter_to(self.bias, shard).to(cd)
        return F.linear(copy_to(x, shard).to(cd), w, bias)


class RowParallelLinear(_ShardedState, Linear):
    """`Linear` holding the rank's slice of the input features; see the
    module doc. `input_sharded`: whether the input is already the rank's
    slice (the output of its column-parallel partner). The partial output
    is summed in f32."""

    input_sharded = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype or x.dtype
        shard = self.weight.tp
        if not self.input_sharded:
            x = scatter_to(x, shard)
        y = reduce_from(F.linear(x.to(cd), self.weight.to(cd)).float(), shard).to(cd)
        return y if self.bias is None else y + self.bias.to(cd)


class ParallelMultiHeadAttention(_ShardedState, MultiHeadAttention):
    """`MultiHeadAttention` whose `in_proj_weight` holds the rank's rows of
    each of q, k and v (head-aligned; see the module doc), gathered after
    the projection."""

    _tp_name = "in_proj_weight"

    def in_projections(self, query, key, value, cd):
        e = self.embed_dim
        shard = self.in_proj_weight.tp
        w = self.in_proj_weight.to(cd).chunk(3, 0)
        bias = self.in_proj_bias.to(cd)
        return tuple(gather_from(F.linear(copy_to(x, shard).to(cd), w[i]), shard)
                     + bias[i * e:(i + 1) * e] for i, x in enumerate((query, key, value)))


def shard_model_(model: nn.Module, mesh) -> Dict[str, int]:
    """Swap every target of `mesh.tp_targets` in place for its parallel
    layer (the module's class changes, its other parameters and their
    `requires_grad` stay), holding the rank's shard; each sharded parameter
    carries its `TPShard` as `.tp`. Returns the targets. Call it with the
    whole weights loaded; `set_trainable` may come before or after (it
    goes by name)."""
    from ziragroundingdino_torch.parallel.mesh import tp_targets

    targets = tp_targets(model, mesh)
    for name, dim in targets.items():
        path, attr = name.rsplit(".", 1)
        mod = model.get_submodule(path)
        old = getattr(mod, attr)
        if isinstance(mod, MultiHeadAttention):
            if mod.embed_dim % mesh.model:
                raise ValueError(f"{name}: embed dim {mod.embed_dim} is not divisible by "
                                 f"{mesh.model} model ranks, which a head-aligned split needs")
            mod.__class__ = ParallelMultiHeadAttention
            shard = TPShard(old.shape, 0, qkv=True)
        elif dim == 0:
            mod.__class__ = ColumnParallelLinear
            partner = next((name[:-len(c)] + r for c, r in PAIRS if name.endswith(c)), None)
            mod.gather_output = partner not in targets
            shard = TPShard(old.shape, 0)
        else:
            mod.__class__ = RowParallelLinear
            partner = next((name[:-len(r)] + c for c, r in PAIRS if name.endswith(r)), None)
            mod.input_sharded = partner in targets
            shard = TPShard(old.shape, 1)
        new = nn.Parameter(shard.local_of(old.detach()), requires_grad=old.requires_grad)
        new.tp = shard
        setattr(mod, attr, new)
    return targets


def is_sharded(p: torch.Tensor) -> bool:
    return getattr(p, "tp", None) is not None


@torch.no_grad()
def mean_replicated_grads_(params: Iterable[torch.Tensor]) -> None:
    """The ranks' copies of one parameter take one update: the gradients of
    the replicated parameters among `params` (those that are not a shard)
    set to their mean over the model axis (see the module doc), and every
    gradient to its mean over the pipe axis (every pipe rank holds whole
    weights; `parallel/pp.py` has already summed an encoder layer's), in
    place, in one all-reduce per axis and dtype. A mean of copies that are
    alike changes nothing, so calls between the updates of an accumulation
    may repeat it. Nothing without a model or pipe axis."""
    params = [p for p in params if p.grad is not None]
    for axis, grads in (("model", [p.grad for p in params if not is_sharded(p)]),
                        ("pipe", [p.grad for p in params])):
        group, size, _ = dist.axis(axis)
        if size == 1:
            continue
        for dtype in sorted({g.dtype for g in grads}, key=str):
            same = [g for g in grads if g.dtype == dtype]
            flat = dist.reduced(torch.cat([g.reshape(-1) for g in same]), group) / size
            for g, v in zip(same, flat.split([g.numel() for g in same])):
                g.copy_(v.view_as(g))
