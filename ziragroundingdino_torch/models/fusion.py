"""Bi-directional vision-language fusion, the port of
the JAX package's `models/fusion.py` (reference `fuse_modules.py`).

`BiMultiHeadAttention`: one image-query x text-key logit matrix drives both
directions. The reference's "stable softmax" prelude (global-max subtract,
+-50000 clamps, `fuse_modules.py:184-202`) is left out as in the JAX
package: softmax is shift-invariant and after a max subtraction the clamps
never bind in f32. `BiAttentionBlock`: pre-LN, layer scale gamma_v/gamma_l
(init 1e-4), residual onto the *normalized* input as in the reference
(`:288-303`). Masks are True = valid. Attention dropout and drop path draw
from the generator given to `forward`, and are off without one.

On the inference path (grad off, no sequence parallelism, attention dropout
inactive, bf16 compute) the attention between the projections is one call of
`ops/fusion_attn.py::fusion_attention`: the hand-written kernel on the card,
its plain version on the CPU. Training (and remat's forward and recompute),
sequence parallelism and f32 runs take the inline path below.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.distributed import ReduceOp

from ziragroundingdino_torch.models.layers import NEG_INF, LayerNorm, Linear, drop_path, dropout
from ziragroundingdino_torch.ops.fusion_attn import fusion_attention
from ziragroundingdino_torch.parallel import dist


class BiMultiHeadAttention(nn.Module):
    def __init__(self, v_dim: int, l_dim: int, embed_dim: int, num_heads: int,
                 compute_dtype: Optional[torch.dtype] = None, dropout: float = 0.0):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.compute_dtype = compute_dtype
        self.dropout = dropout
        kw = dict(compute_dtype=compute_dtype)
        self.v_proj = Linear(v_dim, embed_dim, **kw)
        self.l_proj = Linear(l_dim, embed_dim, **kw)
        self.values_v_proj = Linear(v_dim, embed_dim, **kw)
        self.values_l_proj = Linear(l_dim, embed_dim, **kw)
        self.out_v_proj = Linear(embed_dim, v_dim, **kw)
        self.out_l_proj = Linear(embed_dim, l_dim, **kw)

    def forward(
        self,
        v: torch.Tensor,  # [B, Nv, v_dim]
        l: torch.Tensor,  # [B, Nl, l_dim]
        mask_v: Optional[torch.Tensor] = None,  # [B, Nv] True = valid
        mask_l: Optional[torch.Tensor] = None,  # [B, Nl] True = valid
        generator: Optional[torch.Generator] = None,
        shard=None,  # `parallel.sp.TokenShard` of v's tokens under sequence parallelism
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """With `shard`, v and mask_v are this rank's chunk of the image
        tokens: the softmax over Nv and the text output are taken across
        the seq ranks (max, then the sum of the exponentials, then the
        partial products, each all-reduced), so the text output is the
        same on every rank; dropout draws at the unsharded shape."""
        h = self.num_heads
        hd = self.embed_dim // h
        cd = self.compute_dtype or v.dtype

        if (shard is None and not torch.is_grad_enabled() and cd == torch.bfloat16
                and (generator is None or self.dropout == 0.0)):
            out_v, out_l = fusion_attention(self.v_proj(v) * hd ** -0.5, self.l_proj(l),
                                            self.values_v_proj(v), self.values_l_proj(l),
                                            mask_v, mask_l, h)
            return self.out_v_proj(out_v), self.out_l_proj(out_l)

        def heads(t):
            return t.reshape(t.shape[0], t.shape[1], h, hd).transpose(1, 2)

        q_v = heads(self.v_proj(v) * hd ** -0.5)
        k_l = heads(self.l_proj(l))
        val_v = heads(self.values_v_proj(v))
        val_l = heads(self.values_l_proj(l))

        logits = torch.matmul(q_v, k_l.transpose(-1, -2)).float()  # [B, h, Nv, Nl]
        # text->vision direction: softmax over Nv
        logits_l = logits
        if mask_v is not None:
            logits_l = logits_l.masked_fill(~mask_v[:, None, :, None], NEG_INF)
        if shard is None:
            attn_l = torch.softmax(logits_l, dim=-2)
        else:
            top = dist.reduced(logits_l.detach().amax(-2, keepdim=True), shard.group,
                               ReduceOp.MAX)
            e = torch.exp(logits_l - top)
            attn_l = e / dist.all_reduce_sum(e.sum(-2, keepdim=True), "seq")
        if mask_l is not None:
            logits = logits.masked_fill(~mask_l[:, None, None, :], NEG_INF)
        attn_v = torch.softmax(logits, dim=-1)
        attn_v = dropout(attn_v, self.dropout, generator, shard, dim=2)
        attn_l = dropout(attn_l, self.dropout, generator, shard, dim=2)

        out_v = torch.matmul(attn_v.to(cd), val_l)  # [B, h, Nv, hd]
        out_l = torch.matmul(attn_l.to(cd).transpose(-1, -2), val_v)  # [B, h, Nl, hd]
        if shard is not None:
            out_l = dist.all_reduce_sum(out_l.float(), "seq").to(out_l.dtype)
        out_v = out_v.transpose(1, 2).reshape(v.shape[0], v.shape[1], self.embed_dim)
        out_l = out_l.transpose(1, 2).reshape(l.shape[0], l.shape[1], self.embed_dim)
        return self.out_v_proj(out_v), self.out_l_proj(out_l)


class BiAttentionBlock(nn.Module):
    def __init__(self, v_dim: int, l_dim: int, embed_dim: int, num_heads: int,
                 init_values: float = 1e-4, compute_dtype: Optional[torch.dtype] = None,
                 dropout: float = 0.0, drop_path: float = 0.0):
        super().__init__()
        self.init_values = init_values
        self.drop_path = drop_path
        self.layer_norm_v = LayerNorm(v_dim)
        self.layer_norm_l = LayerNorm(l_dim)
        self.attn = BiMultiHeadAttention(v_dim, l_dim, embed_dim, num_heads, compute_dtype,
                                         dropout)
        self.gamma_v = nn.Parameter(torch.empty(v_dim))
        self.gamma_l = nn.Parameter(torch.empty(l_dim))

    def init_weights(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.gamma_v.fill_(self.init_values)
            self.gamma_l.fill_(self.init_values)

    def forward(self, v, l, mask_v=None, mask_l=None, generator=None, shard=None):
        v = self.layer_norm_v(v)
        l = self.layer_norm_l(l)
        delta_v, delta_l = self.attn(v, l, mask_v=mask_v, mask_l=mask_l, generator=generator,
                                     shard=shard)
        v = v + drop_path(self.gamma_v * delta_v, self.drop_path, generator)
        l = l + drop_path(self.gamma_l * delta_l, self.drop_path, generator)
        return v.to(delta_v.dtype), l.to(delta_l.dtype)
