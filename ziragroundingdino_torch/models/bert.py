"""BERT-base text encoder, the port of the JAX package's `models/bert.py`.

It takes the **3-D block-diagonal attention mask** and **per-span position
ids** of `text.masks` as first-class inputs (what the reference's
`BertModelWarper`, `bertwarper.py:17-166`, feeds HF `BertModel`). HF
numerics: post-LN encoder, LayerNorm eps 1e-12, exact GELU, masked logits
get a large finite negative before an f32 softmax. Module names follow HF
(`bert.encoder.layer.0.attention.self.query.weight`). The pooler is left
out: the reference never uses its output for detection.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ziragroundingdino_torch.config import BertConfig
from ziragroundingdino_torch.models.layers import NEG_INF, Embedding, LayerNorm, Linear


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size, std=0.02)
        self.position_embeddings = Embedding(cfg.max_position_embeddings, cfg.hidden_size, std=0.02)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size, cfg.hidden_size, std=0.02)
        self.LayerNorm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids, position_ids, token_type_ids):
        x = (self.word_embeddings(input_ids) + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.LayerNorm(x)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, compute_dtype):
        super().__init__()
        self.num_heads = cfg.num_attention_heads
        self.query = Linear(cfg.hidden_size, cfg.hidden_size, compute_dtype=compute_dtype)
        self.key = Linear(cfg.hidden_size, cfg.hidden_size, compute_dtype=compute_dtype)
        self.value = Linear(cfg.hidden_size, cfg.hidden_size, compute_dtype=compute_dtype)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor) -> torch.Tensor:
        b, t, e = x.shape
        h = self.num_heads
        hd = e // h
        cd = self.compute_dtype or x.dtype

        def heads(y):
            return y.reshape(b, t, h, hd).transpose(1, 2)

        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        logits = torch.matmul(q, k.transpose(-1, -2)).float() * (hd ** -0.5) + attn_bias
        probs = torch.softmax(logits, dim=-1)
        out = torch.matmul(probs.to(cd), v)
        return out.transpose(1, 2).reshape(b, t, e)


class _DenseNorm(nn.Module):
    """`dense` + residual `LayerNorm` (HF BertSelfOutput / BertOutput)."""

    def __init__(self, d_in: int, d_out: int, eps: float, compute_dtype):
        super().__init__()
        self.dense = Linear(d_in, d_out, compute_dtype=compute_dtype)
        self.LayerNorm = LayerNorm(d_out, eps=eps)

    def forward(self, y, residual):
        return self.LayerNorm(residual + self.dense(y))


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig, compute_dtype):
        super().__init__()
        self.self = BertSelfAttention(cfg, compute_dtype)
        self.output = _DenseNorm(cfg.hidden_size, cfg.hidden_size, cfg.layer_norm_eps,
                                 compute_dtype)

    def forward(self, x, attn_bias):
        return self.output(self.self(x, attn_bias), x)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig, compute_dtype):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.intermediate_size, compute_dtype=compute_dtype)

    def forward(self, x):
        return F.gelu(self.dense(x), approximate="none")


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, compute_dtype):
        super().__init__()
        self.attention = BertAttention(cfg, compute_dtype)
        self.intermediate = BertIntermediate(cfg, compute_dtype)
        self.output = _DenseNorm(cfg.intermediate_size, cfg.hidden_size, cfg.layer_norm_eps,
                                 compute_dtype)

    def forward(self, x, attn_bias):
        x = self.attention(x, attn_bias)
        return self.output(self.intermediate(x), x)


class _LayerStack(nn.Module):
    def __init__(self, cfg: BertConfig, compute_dtype):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg, compute_dtype)
                                   for _ in range(cfg.num_hidden_layers))


class BertEncoder(nn.Module):
    """Returns the last hidden state [B, T, hidden]."""

    def __init__(self, cfg: BertConfig, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = _LayerStack(cfg, compute_dtype)
        self.compute_dtype = compute_dtype

    def forward(
        self,
        input_ids: torch.Tensor,  # [B, T] int
        attention_mask: torch.Tensor,  # [B, T, T] or [B, T] bool, True = attend
        position_ids: Optional[torch.Tensor] = None,  # [B, T]
        token_type_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        b, t = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(t, device=input_ids.device)[None].expand(b, t)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = self.embeddings(input_ids.long(), position_ids.long(), token_type_ids.long())
        x = x.to(self.compute_dtype or x.dtype)
        mask = attention_mask[:, None, None, :] if attention_mask.dim() == 2 \
            else attention_mask[:, None, :, :]
        bias = torch.where(mask, 0.0, NEG_INF).float()
        for layer in self.encoder.layer:
            x = layer(x, bias)
        return x
