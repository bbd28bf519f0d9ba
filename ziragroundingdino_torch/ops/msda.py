"""Multi-scale deformable attention (MSDA): the plain PyTorch version and the
device dispatch.

`ms_deform_attn_plain` has the numerics of the JAX package's
`ms_deform_attn_xla` (`ops/msda.py:496-589`), itself
the reference's grid_sample fallback: ``p = loc * size - 0.5``, the four
corners of ``floor(p)``, each masked for validity (zero padding), corner
weight x attention weight, f32 accumulation and the output in the value
dtype. It is chunked over Q so that the gathered temporary stays bounded at
the encoder shape (~20k queries). It is the CPU path and the plain version
that the CUDA kernel (`msda_cuda.msda_forward`) is held against.

Layouts: value [B, S, H, D]; sampling_locations [B, Q, H, L, P, 2] in [0, 1]
(x, y); attention_weights [B, Q, H, L, P] (already softmaxed); output
[B, Q, H*D].
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

SpatialShapes = Sequence[Tuple[int, int]]


def _corner_indices_and_weights(
    spatial_shapes: SpatialShapes,
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat value-row index and f32 weight of every (level, point, corner):
    both [B, Q, H, L*P*4]."""
    idx_parts, w_parts = [], []
    start = 0
    for lvl, (h_l, w_l) in enumerate(spatial_shapes):
        h_l, w_l = int(h_l), int(w_l)
        loc = sampling_locations[:, :, :, lvl].float()  # [B, Q, H, P, 2]
        attn = attention_weights[:, :, :, lvl].float()  # [B, Q, H, P]
        x = loc[..., 0] * w_l - 0.5
        y = loc[..., 1] * h_l - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        wx1 = x - x0
        wy1 = y - y0
        for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
            # validity is decided on the float coordinates, before any cast
            xf = x0 + dx
            yf = y0 + dy
            valid = (xf >= 0) & (xf < w_l) & (yf >= 0) & (yf < h_l)
            xi = torch.where(valid, xf, 0.0).long()
            yi = torch.where(valid, yf, 0.0).long()
            w = (wx1 if dx else 1.0 - wx1) * (wy1 if dy else 1.0 - wy1)
            idx_parts.append(start + yi * w_l + xi)
            w_parts.append(torch.where(valid, w, 0.0) * attn)
        start += h_l * w_l
    b, q, h = sampling_locations.shape[:3]
    idx = torch.stack(idx_parts, dim=-1).reshape(b, q, h, -1)
    wts = torch.stack(w_parts, dim=-1).reshape(b, q, h, -1)
    return idx, wts


def ms_deform_attn_plain(
    value: torch.Tensor,
    spatial_shapes: SpatialShapes,
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    q_chunk: int = 1024,
) -> torch.Tensor:
    """MSDA forward in plain PyTorch on any device; see the module doc."""
    b, s, h, d = value.shape
    _, q, _, n_levels, n_points, _ = sampling_locations.shape
    if n_levels != len(spatial_shapes):
        raise ValueError(f"{n_levels} levels in locations vs {len(spatial_shapes)} shapes")
    if sum(int(h_) * int(w_) for h_, w_ in spatial_shapes) != s:
        raise ValueError(f"spatial_shapes {tuple(spatial_shapes)} do not sum to S={s}")
    k = n_levels * n_points * 4
    value_bh = value.transpose(1, 2)  # [B, H, S, D]
    out = torch.empty(b, q, h, d, dtype=torch.float32, device=value.device)
    for q0 in range(0, q, q_chunk):
        q1 = min(q, q0 + q_chunk)
        idx, wts = _corner_indices_and_weights(
            spatial_shapes, sampling_locations[:, q0:q1], attention_weights[:, q0:q1]
        )
        qc = q1 - q0
        idx_bh = idx.transpose(1, 2).reshape(b, h, qc * k, 1).expand(b, h, qc * k, d)
        g = torch.gather(value_bh, 2, idx_bh).reshape(b, h, qc, k, d)
        o = torch.einsum("bhqkd,bhqk->bhqd", g.float(), wts.transpose(1, 2))
        out[:, q0:q1] = o.transpose(1, 2)
    return out.reshape(b, q, h * d).to(value.dtype)


def ms_deform_attn(
    value: torch.Tensor,
    spatial_shapes: SpatialShapes,
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """The port's one MSDA: CPU tensors take the plain version, CUDA tensors
    the hand-written kernel; any other device raises."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if value.device.type == "cpu":
        return ms_deform_attn_plain(
            value, spatial_shapes, sampling_locations, attention_weights
        )
    if value.device.type == "cuda":
        from ziragroundingdino_torch.ops.msda_cuda import msda_forward

        return msda_forward(value, spatial_shapes, sampling_locations, attention_weights)
    raise ValueError(f"MSDA has no implementation for device {value.device}")
