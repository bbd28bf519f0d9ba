"""Sine position embedding of image feature maps, the port of
the JAX package's `models/position_encoding.py` (reference
`PositionEmbeddingSineHW`, `backbone/position_encoding.py:78-135`:
normalize=True, separate H/W temperatures). Channels last; the mask is
True = valid pixel."""

from __future__ import annotations

import math

import torch


def position_embedding_sine_hw(
    mask: torch.Tensor,  # [B, H, W] bool, True = valid
    num_pos_feats: int = 128,
    temperature_h: float = 20.0,
    temperature_w: float = 20.0,
    scale: float = 2.0 * math.pi,
) -> torch.Tensor:
    """Returns [B, H, W, 2*num_pos_feats] f32 position embedding."""
    not_mask = mask.float()
    y_embed = torch.cumsum(not_mask, dim=1)
    x_embed = torch.cumsum(not_mask, dim=2)

    eps = 1e-6
    y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale

    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=mask.device)
    dim_tx = temperature_w ** (2.0 * torch.floor(dim_t / 2.0) / num_pos_feats)
    dim_ty = temperature_h ** (2.0 * torch.floor(dim_t / 2.0) / num_pos_feats)

    pos_x = x_embed[..., None] / dim_tx
    pos_y = y_embed[..., None] / dim_ty
    pos_x = torch.stack((torch.sin(pos_x[..., 0::2]), torch.cos(pos_x[..., 1::2])), dim=-1).flatten(-2)
    pos_y = torch.stack((torch.sin(pos_y[..., 0::2]), torch.cos(pos_y[..., 1::2])), dim=-1).flatten(-2)
    return torch.cat((pos_y, pos_x), dim=-1)
