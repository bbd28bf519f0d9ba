"""`ContrastiveEmbed` (`models/GroundingDINO/utils.py:234-269`), the port of
the JAX package's `models/heads.py`: query x text-token dot product,
padded tokens set to the finite `NEG_INF`, padded out to max_text_len.
With `use_linear` it is `ContrastiveEmbedwithLinear` (`utils.py:272-310`,
linear probing): the queries first pass a trainable `cls_linear`. The box
head is `layers.MLP`."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ziragroundingdino_torch.models.layers import NEG_INF, Linear


class ContrastiveEmbed(nn.Module):
    def __init__(self, max_text_len: int = 256, use_linear: bool = False,
                 hidden_dim: int = 256, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.max_text_len = max_text_len
        self.cls_linear = (Linear(hidden_dim, hidden_dim, compute_dtype=compute_dtype)
                           if use_linear else None)

    def forward(self, x: torch.Tensor, text_dict: dict) -> torch.Tensor:
        """x [B, Q, E]; text_dict['encoded_text'] [B, T, E],
        text_dict['text_token_mask'] [B, T] True = valid. Returns
        [B, Q, max_text_len] f32 logits."""
        y = text_dict["encoded_text"]
        mask = text_dict["text_token_mask"]
        if self.cls_linear is not None:
            x = self.cls_linear(x)
        res = torch.matmul(x, y.transpose(-1, -2)).float()
        res = res.masked_fill(~mask[:, None, :], NEG_INF)
        t = res.shape[-1]
        if t < self.max_text_len:
            pad = res.new_full((*res.shape[:-1], self.max_text_len - t), NEG_INF)
            res = torch.cat([res, pad], dim=-1)
        return res
