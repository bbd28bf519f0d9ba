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

`ms_deform_attn_backward_plain` computes the three gradients explicitly, with
the semantics of the JAX package's hand-written backward (`_quad_bwd`,
`ops/msda.py:671-810`): the bilinear weights are differentiated, `floor` and
the validity mask are constants. It is the plain version of the CUDA
backward kernel (`msda_cuda.msda_backward`); the CPU path differentiates
`ms_deform_attn_plain` with autograd instead.

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


def ms_deform_attn_backward_plain(
    value: torch.Tensor,
    spatial_shapes: SpatialShapes,
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    grad_out: torch.Tensor,
    q_chunk: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of `ms_deform_attn_plain` for the output gradient grad_out
    [B, Q, H*D]: (d_value in the value dtype, summed in f32; d_loc and
    d_attn in f32). Per corner c of a sample, with dot_c = <g, v_c> and x =
    loc_x * w_l - 0.5: d_value[row_c] += valid_c * w_c * attn * g, d_attn =
    sum_c valid_c * w_c * dot_c, d_loc = attn * sum_c valid_c * (dw_c/dx,
    dw_c/dy) * dot_c * (w_l, h_l)."""
    b, s, h, d = value.shape
    _, q, _, n_levels, n_points, _ = sampling_locations.shape
    value_bh = value.transpose(1, 2).float()  # [B, H, S, D]
    g_all = grad_out.reshape(b, q, h, d).float()
    d_value = torch.zeros(b, h, s, d, dtype=torch.float32, device=value.device)
    d_loc = torch.empty(sampling_locations.shape, dtype=torch.float32, device=value.device)
    d_attn = torch.empty(attention_weights.shape, dtype=torch.float32, device=value.device)
    flat = d_value.reshape(b * h * s, d)
    bh_base = ((torch.arange(b, device=value.device)[:, None] * h
                + torch.arange(h, device=value.device)[None, :]) * s)  # [B, H]
    for q0 in range(0, q, q_chunk):
        q1 = min(q, q0 + q_chunk)
        g = g_all[:, q0:q1].transpose(1, 2)  # [B, H, qc, D]
        start = 0
        for lvl, (h_l, w_l) in enumerate(spatial_shapes):
            h_l, w_l = int(h_l), int(w_l)
            loc = sampling_locations[:, q0:q1, :, lvl].float().transpose(1, 2)  # [B,H,qc,P,2]
            attn = attention_weights[:, q0:q1, :, lvl].float().transpose(1, 2)  # [B,H,qc,P]
            x = loc[..., 0] * w_l - 0.5
            y = loc[..., 1] * h_l - 0.5
            x0 = torch.floor(x)
            y0 = torch.floor(y)
            fx, fy = x - x0, y - y0
            wx, wy = (1.0 - fx, fx), (1.0 - fy, fy)
            sx = (-1.0, 1.0)
            da = torch.zeros_like(attn)
            dx = torch.zeros_like(attn)
            dy = torch.zeros_like(attn)
            for cy, cx in ((0, 0), (0, 1), (1, 0), (1, 1)):
                xf, yf = x0 + cx, y0 + cy
                valid = ((xf >= 0) & (xf < w_l) & (yf >= 0) & (yf < h_l)).float()
                row = start + (torch.where(valid > 0, yf, 0.0) * w_l
                               + torch.where(valid > 0, xf, 0.0)).long()  # [B,H,qc,P]
                v = torch.gather(value_bh, 2, row.flatten(2)[..., None].expand(-1, -1, -1, d))
                dot = (v.reshape(*row.shape, d) * g[:, :, :, None]).sum(-1) * valid
                w = wx[cx] * wy[cy]
                da = da + w * dot
                dx = dx + sx[cx] * wy[cy] * dot
                dy = dy + wx[cx] * sx[cy] * dot
                contrib = (valid * w * attn)[..., None] * g[:, :, :, None]  # [B,H,qc,P,D]
                flat.index_add_(0, (bh_base[:, :, None, None] + row).reshape(-1),
                                contrib.reshape(-1, d))
            d_attn[:, q0:q1, :, lvl] = da.transpose(1, 2)
            d_loc[:, q0:q1, :, lvl] = torch.stack(
                (attn * dx * w_l, attn * dy * h_l), -1).transpose(1, 2)
            start += h_l * w_l
    return d_value.transpose(1, 2).to(value.dtype), d_loc, d_attn


class _MSDAFunction(torch.autograd.Function):
    """MSDA on the card: `msda_forward` forward, `msda_backward` backward.
    Saves only value, loc and attn (the memory-lean residual of the JAX
    package's rule, `ops/msda.py:668`)."""

    @staticmethod
    def forward(ctx, value, sampling_locations, attention_weights, spatial_shapes):
        from ziragroundingdino_torch.ops.msda_cuda import msda_forward

        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        return msda_forward(value.detach(), spatial_shapes, sampling_locations.detach(),
                            attention_weights.detach())

    @staticmethod
    def backward(ctx, grad_out):
        from ziragroundingdino_torch.ops.msda_cuda import msda_backward

        value, loc, attn = ctx.saved_tensors
        d_value, d_loc, d_attn = msda_backward(
            value.detach(), ctx.spatial_shapes, loc.detach(), attn.detach(),
            grad_out.contiguous())
        need = ctx.needs_input_grad
        return (d_value if need[0] else None, d_loc if need[1] else None,
                d_attn if need[2] else None, None)


def ms_deform_attn(
    value: torch.Tensor,
    spatial_shapes: SpatialShapes,
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """The port's one MSDA: CPU tensors take the plain version (autograd
    differentiates it), CUDA tensors the hand-written kernels (the forward
    alone when no input needs a gradient, else forward and backward through
    `_MSDAFunction`); any other device raises."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if value.device.type == "cpu":
        return ms_deform_attn_plain(
            value, spatial_shapes, sampling_locations, attention_weights
        )
    if value.device.type == "cuda":
        inputs = (value, sampling_locations, attention_weights)
        if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
            return _MSDAFunction.apply(*inputs, spatial_shapes)
        from ziragroundingdino_torch.ops.msda_cuda import msda_forward

        return msda_forward(value, spatial_shapes, sampling_locations, attention_weights)
    raise ValueError(f"MSDA has no implementation for device {value.device}")
