"""Shared building blocks, the port of the JAX package's `models/layers.py`.

Conventions kept from the JAX package: batch-first; boolean masks with
True = attend / valid; parameters in float32 and matmuls in a compute dtype
given per module (a bf16 matmul casts its f32 weight per call, as the JAX
`Dense` does); LayerNorm and softmax in f32; `NEG_INF` finite.

Dropout and stochastic depth (`dropout`, `drop_path`) draw their masks from
an explicit `torch.Generator` passed down the forward; with none they are
the identity, as the JAX package's `deterministic=True`.

Parameters are created empty and filled by `init_weights(model, generator)`
from an explicit `torch.Generator`: every module that owns parameters
either has an `init_weights(generator)` method or is a norm layer, and any
other module raises there, so no parameter is left unset.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

# Large negative for masked attention logits. Finite (not -inf) so that a
# fully-masked row gives uniform attention instead of NaN.
NEG_INF = -1.0e9


def _uniform_(t: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=gen)


def xavier_uniform_(t: torch.Tensor, fan_in: int, fan_out: int, gen: torch.Generator) -> None:
    _uniform_(t, math.sqrt(6.0 / (fan_in + fan_out)), gen)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout (kept entries scaled by 1 / (1 - rate), as the JAX
    package's `Dropout`) with its mask drawn from `generator`; the identity
    when `generator` is None or `rate` is 0."""
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def drop_path(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Stochastic depth (`DropPath`, `models/layers.py:114-128` of the JAX
    package, timm semantics): the whole residual branch of a sample is
    dropped, kept ones scaled by 1 / (1 - rate); identity as `dropout`."""
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


class Linear(nn.Linear):
    """`nn.Linear` that computes in `compute_dtype` (None: the input's dtype).

    init: "torch" (nn.Linear's default, U(+-1/sqrt(in)) on weight and bias),
    "xavier" (xavier-uniform weight, zero bias), "zeros", or a float that
    fills weight and bias (the ZiRa branches' 1e-8).
    """

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: Optional[torch.dtype] = None, init: Union[str, float] = "torch"):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype
        self.init = init

    def reset_parameters(self) -> None:
        # filled by init_weights from an explicit generator
        pass

    def init_weights(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            if self.init == "torch":
                bound = 1.0 / math.sqrt(self.in_features)
                _uniform_(self.weight, bound, gen)
                if self.bias is not None:
                    _uniform_(self.bias, bound, gen)
            elif self.init == "xavier":
                xavier_uniform_(self.weight, self.in_features, self.out_features, gen)
                if self.bias is not None:
                    self.bias.zero_()
            elif self.init == "zeros":
                self.weight.zero_()
                if self.bias is not None:
                    self.bias.zero_()
            elif isinstance(self.init, float):
                self.weight.fill_(self.init)
                if self.bias is not None:
                    self.bias.fill_(self.init)
            else:
                raise ValueError(f"unknown init {self.init!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype or x.dtype
        bias = None if self.bias is None else self.bias.to(cd)
        return F.linear(x.to(cd), self.weight.to(cd), bias)


class Embedding(nn.Embedding):
    """nn.Embedding filled with normal(0, std) by init_weights."""

    def __init__(self, num_embeddings: int, embedding_dim: int, std: float):
        super().__init__(num_embeddings, embedding_dim)
        self.std = std

    def reset_parameters(self) -> None:
        pass

    def init_weights(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, self.std, generator=gen)


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed in f32, returned in the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight, self.bias, self.eps
        ).to(x.dtype)


class MLP(nn.Module):
    """DETR-style MLP with ReLU between layers (`utils.py:171-186`)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int,
                 zero_init_last: bool = False, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        dims_in = [input_dim] + [hidden_dim] * (num_layers - 1)
        dims_out = [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            Linear(i, o, compute_dtype=compute_dtype,
                   init="zeros" if (zero_init_last and n == num_layers - 1) else "torch")
            for n, (i, o) in enumerate(zip(dims_in, dims_out))
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MultiHeadAttention(nn.Module):
    """`nn.MultiheadAttention` semantics, batch-first, with the reference's
    parameter names (`in_proj_weight` [3E, E], `in_proj_bias`, `out_proj`).
    Scaled logits in f32, masks as `NEG_INF`, f32 softmax."""

    def __init__(self, embed_dim: int, num_heads: int,
                 compute_dtype: Optional[torch.dtype] = None, dropout: float = 0.0):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} not divisible by {num_heads} heads")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.compute_dtype = compute_dtype
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim, compute_dtype=compute_dtype)

    def init_weights(self, gen: torch.Generator) -> None:
        _uniform_(self.in_proj_weight, 1.0 / math.sqrt(self.embed_dim), gen)
        with torch.no_grad():
            self.in_proj_bias.zero_()

    def forward(
        self,
        query: torch.Tensor,  # [B, Tq, E]
        key: torch.Tensor,  # [B, Tk, E]
        value: torch.Tensor,  # [B, Tk, E]
        attn_mask: Optional[torch.Tensor] = None,  # [B, Tq, Tk] bool, True=attend
        key_padding_mask: Optional[torch.Tensor] = None,  # [B, Tk] bool, True=valid
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        e, h = self.embed_dim, self.num_heads
        hd = e // h
        cd = self.compute_dtype or query.dtype
        w = self.in_proj_weight.to(cd)
        bias = self.in_proj_bias.to(cd)
        q = F.linear(query.to(cd), w[:e], bias[:e])
        k = F.linear(key.to(cd), w[e:2 * e], bias[e:2 * e])
        v = F.linear(value.to(cd), w[2 * e:], bias[2 * e:])

        def split_heads(t):
            b, s, _ = t.shape
            return t.reshape(b, s, h, hd).transpose(1, 2)  # [B, H, S, hd]

        q, k, v = map(split_heads, (q, k, v))
        logits = torch.matmul(q, k.transpose(-1, -2)).float() * (1.0 / math.sqrt(hd))
        if attn_mask is not None:
            logits = logits.masked_fill(~attn_mask[:, None, :, :], NEG_INF)
        if key_padding_mask is not None:
            logits = logits.masked_fill(~key_padding_mask[:, None, None, :], NEG_INF)
        probs = dropout(torch.softmax(logits, dim=-1).to(cd), self.dropout, generator)
        out = torch.matmul(probs, v)
        out = out.transpose(1, 2).reshape(query.shape[0], query.shape[1], e)
        return self.out_proj(out)


def get_sine_pos_embed(
    pos: torch.Tensor,
    num_pos_feats: int = 128,
    temperature: float = 10000.0,
    exchange_xy: bool = True,
) -> torch.Tensor:
    """Sine embedding of a position tensor (`utils.py:24-53`):
    [..., n] -> [..., n * num_pos_feats]."""
    scale = 2.0 * math.pi
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=pos.device)
    dim_t = temperature ** (2.0 * torch.floor(dim_t / 2.0) / num_pos_feats)

    def sine(x):  # [..., 1]
        s = x.float() * scale / dim_t
        return torch.stack((torch.sin(s[..., 0::2]), torch.cos(s[..., 1::2])), dim=-1).flatten(-2)

    parts = [sine(pos[..., i:i + 1]) for i in range(pos.shape[-1])]
    if exchange_xy and len(parts) >= 2:
        parts[0], parts[1] = parts[1], parts[0]
    return torch.cat(parts, dim=-1)


def gen_sineembed_for_position(pos: torch.Tensor, num_feats: int = 128) -> torch.Tensor:
    """Box-coordinate sine embedding (`utils.py:203-230`): [..., 2 or 4] ->
    concat of num_feats-dim embeddings ordered (y, x[, w, h])."""
    scale = 2.0 * math.pi
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=pos.device)
    dim_t = 10000.0 ** (2.0 * torch.floor(dim_t / 2.0) / num_feats)

    def embed(coord):
        p = coord.float()[..., None] * scale / dim_t
        return torch.stack((torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])), dim=-1).flatten(-2)

    x = embed(pos[..., 0])
    y = embed(pos[..., 1])
    if pos.shape[-1] == 2:
        return torch.cat((y, x), dim=-1)
    return torch.cat((y, x, embed(pos[..., 2]), embed(pos[..., 3])), dim=-1)


def activation_fn(name: str) -> Callable:
    """`utils.py:189-200`, as the JAX package configures it: "gelu" is
    `jax.nn.gelu`'s default, the tanh approximation."""
    return {
        "relu": F.relu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "selu": F.selu,
        "glu": F.glu,
    }[name]


def init_weights(model: nn.Module, gen: torch.Generator) -> None:
    """Fill every parameter of `model` from `gen` (see the module doc)."""
    for m in model.modules():
        if not any(True for _ in m.parameters(recurse=False)):
            continue
        if hasattr(m, "init_weights"):
            m.init_weights(gen)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            with torch.no_grad():
                m.weight.fill_(1.0)
                m.bias.zero_()
        else:
            raise TypeError(f"no init rule for {type(m).__name__}")
