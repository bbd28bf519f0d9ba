"""Parameter-efficient adapters, the port of the JAX package's
`models/adapters.py` (reference `models/GroundingDINO/adapter.py`):
  * `Adapter` (`adapter.py:124-179`): down projection (kaiming-uniform),
    ReLU, zero-init up projection, scaled by a cosine-similarity gate
    against learned gate embeddings, base_scale * sigmoid(T * sim);
  * `LinearAdapter` (`adapter.py:7-58`): one zero-init linear and the gate;
  * `TransformerAdapter` (`adapter.py:61-121`): a transformer encoder layer
    and a zero-init output projection;
  * `MoeAdapter` (`adapter.py:182-219`): `moe.MoE` and a fixed scale.

Each returns (output, f32 loss): the self-KD L1 of the input (of the
output for `TransformerAdapter`) where `use_self_kd`, the MoE balancing
loss for `MoeAdapter`, else 0. Parameter names are the reference's
(`adapter_down`, `adapter_up`, `linear`, `gate.weight`, `self_attn`,
`norm1`, `linear1`, `linear2`, `norm2`, `project_out`, `adapter_moe`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ziragroundingdino_torch.models.layers import LayerNorm, Linear, MultiHeadAttention
from ziragroundingdino_torch.models.moe import MoE


def zero_loss(x: torch.Tensor) -> torch.Tensor:
    """The f32 loss of a module that has none, on x's device."""
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _self_kd(x: torch.Tensor, use: bool, shard=None) -> torch.Tensor:
    """The self-KD L1 of x. A plain mean: under data parallelism every
    rank's x has one shape, so the ranks' mean of it (DDP's) is the global
    batch's. Under sequence parallelism (`shard`, x this rank's chunk of the
    tokens, which may hold padding) the sum over the real tokens over their
    global count (`parallel.sp.TokenShard.mean`)."""
    if not use:
        return zero_loss(x)
    return x.float().abs().mean() if shard is None else shard.mean(x.float().abs())


class _Gate(nn.Module):
    """Cosine-similarity gate (`adapter.py:40-49,161-171`): base_scale *
    sigmoid(T * the largest cosine similarity between a token and the
    `num_gate_embed` gate embeddings), [..., 1] in f32. The norms take no
    epsilon, as in the reference."""

    def __init__(self, embed_dim: int, num_gate_embed: int = 5, gate_t: float = 2.0,
                 gate_base_scale: float = 0.5):
        super().__init__()
        self.gate_t, self.gate_base_scale = gate_t, gate_base_scale
        self.weight = nn.Parameter(torch.empty(num_gate_embed, embed_dim))

    def init_weights(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0, generator=gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        xn = xf / torch.linalg.vector_norm(xf, dim=-1, keepdim=True)
        gn = self.weight / torch.linalg.vector_norm(self.weight, dim=-1, keepdim=True)
        sim = torch.matmul(xn, gn.t()).amax(-1)
        return (self.gate_base_scale * torch.sigmoid(self.gate_t * sim))[..., None]


class CetBranch(nn.Module):
    """An adapter as the CET language branch: the language branches' call
    shape (`zira.LanguageBranch`), the same forward in both modes, over
    every token."""

    def text_branch(self, x: torch.Tensor, train: bool, mask: Optional[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self(x)


class Adapter(CetBranch):
    def __init__(self, embed_dim: int = 256, down_dim: int = 64, gate_base_scale: float = 0.5,
                 use_self_kd: bool = True, output_dim: Optional[int] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.use_self_kd = use_self_kd
        self.adapter_down = Linear(embed_dim, down_dim, compute_dtype=compute_dtype,
                                   init="kaiming")
        self.adapter_up = Linear(down_dim, output_dim or embed_dim, compute_dtype=compute_dtype,
                                 init="zeros")
        self.gate = _Gate(embed_dim, gate_base_scale=gate_base_scale)

    def forward(self, x: torch.Tensor, shard=None) -> Tuple[torch.Tensor, torch.Tensor]:
        y = self.adapter_up(torch.relu(self.adapter_down(x)))
        return (y * self.gate(x)).to(y.dtype), _self_kd(x, self.use_self_kd, shard)


class LinearAdapter(CetBranch):
    def __init__(self, embed_dim: int = 256, gate_base_scale: float = 0.5,
                 use_self_kd: bool = True, output_dim: Optional[int] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.use_self_kd = use_self_kd
        self.linear = Linear(embed_dim, output_dim or embed_dim, compute_dtype=compute_dtype,
                             init="zeros")
        self.gate = _Gate(embed_dim, gate_base_scale=gate_base_scale)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        y = self.linear(x)
        return (y * self.gate(x)).to(y.dtype), _self_kd(x, self.use_self_kd)


class TransformerAdapter(CetBranch):
    """Self-attention over every token (no mask, as the reference), LN, a
    ReLU FFN of width `down_dim`, LN, then the zero-init `project_out`."""

    def __init__(self, embed_dim: int, nhead: int = 8, down_dim: int = 2048,
                 use_self_kd: bool = False, output_dim: Optional[int] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.use_self_kd = use_self_kd
        self.self_attn = MultiHeadAttention(embed_dim, nhead, compute_dtype)
        self.norm1 = LayerNorm(embed_dim)
        self.linear1 = Linear(embed_dim, down_dim, compute_dtype=compute_dtype)
        self.linear2 = Linear(down_dim, embed_dim, compute_dtype=compute_dtype)
        self.norm2 = LayerNorm(embed_dim)
        self.project_out = Linear(embed_dim, output_dim or embed_dim,
                                  compute_dtype=compute_dtype, init="zeros")

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        attn = self.self_attn(x, x, x)
        x = self.norm1(x + attn).to(attn.dtype)
        y = self.linear2(torch.relu(self.linear1(x)))
        x = self.norm2(x + y).to(y.dtype)
        out = self.project_out(x)
        return out, _self_kd(out, self.use_self_kd)


class MoeAdapter(nn.Module):
    """`MoE` over the tokens of x [B, N, d], times a fixed `gate_base_scale`;
    the loss is the MoE's, plus the output's self-KD L1 where `use_self_kd`."""

    def __init__(self, embed_dim: int = 256, down_dim: int = 64, gate_base_scale: float = 0.5,
                 num_experts: int = 1, topk: int = 1, use_self_kd: bool = True,
                 output_dim: Optional[int] = None, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.gate_base_scale = gate_base_scale
        self.use_self_kd = use_self_kd
        self.adapter_moe = MoE(embed_dim, output_dim or embed_dim, num_experts, down_dim,
                               k=topk, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """`generator` / `noise` [B * N, E]: the MoE's noisy gating."""
        b, n, d = x.shape
        y, loss = self.adapter_moe(x.reshape(b * n, d), generator, noise)
        y = y.reshape(b, n, -1)
        if self.use_self_kd:  # a mean over equal-shaped shards: global under DDP
            loss = loss + y.float().abs().mean()
        return y * self.gate_base_scale, loss


# the CET language adapter's shapes, by `cfg.cet_type`
CET_ADAPTERS = {"Adapter": Adapter, "Linear": LinearAdapter, "Transformer": TransformerAdapter}


def cet_adapter(cfg, compute_dtype: Optional[torch.dtype]) -> nn.Module:
    """The CET language adapter over the BERT output (`groundingdino_dt.py:
    182-206`; `models/groundingdino.py:143-164` of the JAX package): no
    self-KD, `cet_middle_dim` wide, a gate base scale of 1."""
    kw = dict(embed_dim=cfg.bert.hidden_size, output_dim=cfg.hidden_dim, use_self_kd=False,
              compute_dtype=compute_dtype)
    if cfg.cet_type != "Linear":
        kw["down_dim"] = cfg.cet_middle_dim
    if cfg.cet_type != "Transformer":
        kw["gate_base_scale"] = 1.0
    return CET_ADAPTERS[cfg.cet_type](**kw)
