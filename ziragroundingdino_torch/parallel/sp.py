"""Sequence parallelism over the encoder's image tokens, the port of the JAX
package's `parallel/sp.py` (`:38-134`). The reference has none (its only
long-sequence mitigation is activation checkpointing); the JAX package
shards the ~20k encoder tokens over a `seq` mesh axis with sharding
constraints and a query-sharded MSDA. Here the ranks of the seq axis hold
contiguous chunks of the tokens and the model issues the collectives:

  * `sequence_parallel(mesh)` is a context, as JAX's: inside it the
    encoder (`models.transformer.FeatureEnhancer`) takes a `TokenShard` of
    its S tokens: S padded to a multiple of the seq size by repeating the
    last token (so a padded token computes what a real one does and never
    meets a 0/0), each rank's chunk taken with its key-padding mask False
    on the padding, and the tokens gathered once after the last layer;
  * MSDA (`msda_query_sharded`, `models.transformer.MSDeformAttn`): the
    value table of the local tokens is all-gathered to [B, S, H, D] and
    the kernel runs on the local queries; in the backward the kernel's
    partial `d_value` over the whole table is reduce-scattered back to its
    owners. The decoder's cross-attention splits its 900 queries the same
    way, with the memory whole, and gathers its output;
  * the text->image softmax of the fusion layers is taken across the ranks
    (`models.fusion`), so the text, BERT and the decoder run replicated;
  * a padded token enters no softmax (its key mask is False) and no mean
    (`TokenShard.mean`).

Gradients: every seq rank computes the same loss, and the collectives are
true adjoints (`parallel.dist.all_gather`, `all_reduce_sum`), so the
ranks' gradients add up to the seq axis's size times the gradient of the
loss: a parameter used on the token chunks gets its chunk's share there,
one used by the replicated parts all of it on every rank. DDP's mean over
the data x seq group (`train.step.wrap_ddp`) is then the gradient of the
global batch's loss.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

import torch

from ziragroundingdino_torch.ops import msda
from ziragroundingdino_torch.parallel import dist

_STACK: list = []


@contextmanager
def sequence_parallel(mesh):
    """Shard the encoder's tokens over the mesh's seq axis inside the
    context; a seq axis of one rank makes every hook a no-op."""
    if "seq" not in mesh.axes:
        raise ValueError(f"mesh {mesh} has no 'seq' axis; build it with make_mesh(..., seq=N)")
    _STACK.append(mesh)
    try:
        yield
    finally:
        _STACK.pop()


def active_mesh():
    """The mesh of the innermost `sequence_parallel`, where its seq axis has
    more than one rank; else None."""
    m = _STACK[-1] if _STACK else None
    return m if m is not None and m.seq > 1 else None


class TokenShard:
    """This rank's chunk of a token axis of length `n` over the seq axis:
    positions [lo, lo + chunk) of the axis padded to chunk * size by
    repeating its last position; `valid` of them are real."""

    def __init__(self, n: int, device):
        self.group, self.size, self.rank = dist.axis("seq")
        self.n = n
        self.chunk = -(-n // self.size)
        self.lo = self.rank * self.chunk
        self.valid = max(min(n - self.lo, self.chunk), 0)
        self.index = torch.arange(self.lo, self.lo + self.chunk, device=device).clamp_(max=n - 1)

    def take(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's chunk of `x` along `dim` (differentiable, local)."""
        return x.index_select(dim, self.index)

    def take_mask(self, mask: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of a [B, n] key mask (True = valid), False on
        the padding."""
        keep = self.take(mask, 1)
        if self.valid < self.chunk:
            keep = keep.clone()
            keep[:, self.valid:] = False
        return keep

    def gather(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The whole axis from every rank's chunk, the padding dropped; the
        backward reduce-scatters."""
        return dist.all_gather(x, dim, "seq").narrow(dim, 0, self.n)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over every element of the whole tensor whose chunk along
        dim 1 is `x`, the padding left out; the same on every rank."""
        whole = x.numel() // self.chunk * self.n  # the whole tensor's elements
        return dist.all_reduce_sum(x[:, :self.valid].sum(), "seq") / whole

    def full_shape(self, shape, dim: int):
        """`shape` with the token axis `dim` whole."""
        shape = list(shape)
        shape[dim] = self.n
        return shape


def token_shard(n: int, device) -> Optional[TokenShard]:
    """A `TokenShard` of n tokens inside an active `sequence_parallel`,
    else None."""
    return TokenShard(n, device) if active_mesh() is not None else None


def msda_query_sharded(value: torch.Tensor, spatial_shapes, sampling_locations: torch.Tensor,
                       attention_weights: torch.Tensor, shard: TokenShard,
                       value_sharded: bool) -> torch.Tensor:
    """Deformable attention of this rank's queries (`sampling_locations`
    [B, chunk, H, L, K, 2] and `attention_weights` [B, chunk, H, L, K], the
    chunk of `shard`) against the whole value table: `value` [B, S, H, D],
    or, with `value_sharded`, this rank's chunk of it, all-gathered here
    (JAX's `:88-134`: queries are independent given the table)."""
    if value_sharded:
        value = shard.gather(value, 1)
    return msda.ms_deform_attn(value.contiguous(), spatial_shapes,
                               sampling_locations.contiguous(), attention_weights.contiguous())
