"""`ContrastiveEmbed` (`models/GroundingDINO/utils.py:234-269`), the port of
the JAX package's `models/heads.py`: query x text-token dot product,
padded tokens set to the finite `NEG_INF`, padded out to max_text_len. The
box head is `layers.MLP`."""

from __future__ import annotations

import torch
from torch import nn

from ziragroundingdino_torch.models.layers import NEG_INF


class ContrastiveEmbed(nn.Module):
    def __init__(self, max_text_len: int = 256):
        super().__init__()
        self.max_text_len = max_text_len

    def forward(self, x: torch.Tensor, text_dict: dict) -> torch.Tensor:
        """x [B, Q, E]; text_dict['encoded_text'] [B, T, E],
        text_dict['text_token_mask'] [B, T] True = valid. Returns
        [B, Q, max_text_len] f32 logits."""
        y = text_dict["encoded_text"]
        mask = text_dict["text_token_mask"]
        res = torch.matmul(x, y.transpose(-1, -2)).float()
        res = res.masked_fill(~mask[:, None, :], NEG_INF)
        t = res.shape[-1]
        if t < self.max_text_len:
            pad = res.new_full((*res.shape[:-1], self.max_text_len - t), NEG_INF)
            res = torch.cat([res, pad], dim=-1)
        return res
