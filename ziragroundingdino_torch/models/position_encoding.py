"""Position embeddings of image feature maps, the port of the JAX
package's `models/position_encoding.py`: the sine one (reference
`PositionEmbeddingSineHW`, `backbone/position_encoding.py:78-135`:
normalize=True, separate H/W temperatures) and the learned one
(`PositionEmbeddingLearned`, `:137-171`). Channels last; the mask is
True = valid pixel."""

from __future__ import annotations

import math

import torch
from torch import nn

# rows of each learned table (the reference's DETR limit)
LEARNED_ROWS = 50


class _UniformTable(nn.Embedding):
    """A 50-row table filled uniform in [0, 1) by `init_weights`."""

    def __init__(self, dim: int):
        super().__init__(LEARNED_ROWS, dim)

    def reset_parameters(self) -> None:
        pass

    def init_weights(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.uniform_(0.0, 1.0, generator=gen)


class PositionEmbeddingLearned(nn.Module):
    """A learned row and column embedding, one table per axis shared by
    every level (`groundingdino.py:274-283` of the JAX package), initialised
    uniform in [0, 1). It sits at `backbone.1` as in the reference, so the
    checkpoint's `backbone.1.row_embed.weight` / `.col_embed.weight` load by
    name. The reference indexes the tables with `arange(h)` and fails past
    50 rows; indices are clamped to the table as in the JAX package, so
    positions past it share its last row (the stride-8 level at 800x1216 is
    100x152)."""

    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.row_embed = _UniformTable(num_pos_feats)
        self.col_embed = _UniformTable(num_pos_feats)

    def forward(self, mask: torch.Tensor) -> torch.Tensor:
        """mask [B, H, W] (its shape only) -> [B, H, W, 2F] f32: the column
        embedding, then the row embedding."""
        b, h, w = mask.shape
        last = LEARNED_ROWS - 1
        x_emb = self.col_embed.weight[torch.arange(w, device=mask.device).clamp(max=last)]
        y_emb = self.row_embed.weight[torch.arange(h, device=mask.device).clamp(max=last)]
        f = x_emb.shape[-1]
        pos = torch.cat([x_emb[None].expand(h, w, f), y_emb[:, None].expand(h, w, f)], dim=-1)
        return pos[None].expand(b, h, w, 2 * f)


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
