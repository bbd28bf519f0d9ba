"""Swin Transformer backbone, the port of the JAX package's `models/swin.py`
(reference `backbone/swin_transformer.py:501-760`): 4 stages of shifted-window
attention with relative position bias, patch merging between stages and
per-stage output LayerNorms on `out_indices`. NHWC throughout. Stochastic
depth (rates `linspace(0, drop_path_rate)` over the blocks, `swin.py:276` of
the JAX package) draws from the generator given to `forward`, and is off
without one. Every variant of `config.SWIN_VARIANTS` (window 7 or 12) runs
through the same code: each block pads its input to the window, and
`use_checkpoint` recomputes each block in the backward (`models/remat.py`).

Module names follow the reference checkpoint (`backbone.0.layers.1.blocks.0.
attn.qkv.weight`). The relative-position index and the shift mask are static
numpy tables, turned into tensors per device on first use.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ziragroundingdino_torch.config import SwinConfig
from ziragroundingdino_torch.device import DeviceTables
from ziragroundingdino_torch.models.layers import LayerNorm, Linear, drop_path
from ziragroundingdino_torch.models.remat import checkpoint


@functools.lru_cache(maxsize=None)
def _relative_position_index(wh: int, ww: int) -> np.ndarray:
    """Static [wh*ww, wh*ww] index into the (2wh-1)(2ww-1) bias table
    (`swin_transformer.py:110-124`)."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0).copy()
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=None)
def _shift_attn_mask(hp: int, wp: int, window: int, shift: int) -> np.ndarray:
    """Static additive mask [nW, N, N] for shifted windows
    (`swin_transformer.py:416-443`): 0 where tokens share a region, -100
    across the cyclic-shift seam."""
    img_mask = np.zeros((hp, wp), dtype=np.int32)
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    cnt = 0
    for h in slices:
        for w in slices:
            img_mask[h, w] = cnt
            cnt += 1
    nh, nw = hp // window, wp // window
    win = img_mask.reshape(nh, window, nw, window).transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    """W-MSA with relative position bias (`swin_transformer.py:77-175`)."""

    def __init__(self, dim: int, window: int, num_heads: int, qkv_bias: bool = True,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.window = window
        self.num_heads = num_heads
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window - 1) ** 2, num_heads))
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias, compute_dtype=compute_dtype)
        self.proj = Linear(dim, dim, compute_dtype=compute_dtype)
        self.compute_dtype = compute_dtype
        self._tables = DeviceTables()

    def init_weights(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.relative_position_bias_table.normal_(0.0, 0.02, generator=gen)

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor]) -> torch.Tensor:
        # x: [B*nW, N, C] with N = window**2; attn_mask: [nW, N, N] or None
        bw, n, c = x.shape
        h = self.num_heads
        hd = c // h
        cd = self.compute_dtype or x.dtype
        rel_idx = self._tables.get(
            ("rel", self.window), x.device,
            lambda: _relative_position_index(self.window, self.window).reshape(-1))
        rel_bias = self.relative_position_bias_table[rel_idx].reshape(n, n, h).permute(2, 0, 1)

        qkv = self.qkv(x).reshape(bw, n, 3, h, hd).permute(2, 0, 3, 1, 4)  # [3, B*nW, h, N, hd]
        q, k, v = qkv[0], qkv[1], qkv[2]
        logits = torch.matmul(q * (hd ** -0.5), k.transpose(-1, -2)).float()
        logits = logits + rel_bias[None].float()
        if attn_mask is not None:
            nw = attn_mask.shape[0]
            logits = logits.reshape(bw // nw, nw, h, n, n) + attn_mask[None, :, None]
            logits = logits.reshape(bw, h, n, n)
        probs = torch.softmax(logits, dim=-1).to(cd)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(bw, n, c)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fc1 = Linear(dim, hidden, compute_dtype=compute_dtype)
        self.fc2 = Linear(hidden, dim, compute_dtype=compute_dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class SwinBlock(nn.Module):
    """One (shifted-)window transformer block (`swin_transformer.py:177-293`)."""

    def __init__(self, dim: int, num_heads: int, window: int, shift: int, mlp_ratio: float,
                 qkv_bias: bool, compute_dtype: Optional[torch.dtype] = None,
                 drop_path: float = 0.0):
        super().__init__()
        self.window = window
        self.shift = shift
        self.drop_path = drop_path
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, window, num_heads, qkv_bias, compute_dtype)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), compute_dtype)
        self._tables = DeviceTables()

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, h, w, c = x.shape
        window, shift = self.window, self.shift
        shortcut = x
        x = self.norm1(x)
        pad_b = (window - h % window) % window
        pad_r = (window - w % window) % window
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r
        if shift > 0:
            x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
            attn_mask = self._tables.get(
                ("shift", hp, wp, window, shift), x.device,
                lambda: _shift_attn_mask(hp, wp, window, shift))
        else:
            attn_mask = None
        nh, nw = hp // window, wp // window
        xw = x.reshape(b, nh, window, nw, window, c).permute(0, 1, 3, 2, 4, 5)
        xw = xw.reshape(b * nh * nw, window * window, c)
        xw = self.attn(xw, attn_mask)
        x = xw.reshape(b, nh, nw, window, window, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, hp, wp, c)
        if shift > 0:
            x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
        x = shortcut + drop_path(x[:, :h, :w, :], self.drop_path, generator)
        return x + drop_path(self.mlp(self.norm2(x)), self.drop_path, generator)


class PatchMerging(nn.Module):
    """2x2 patch concat + LN + linear 4C->2C (`swin_transformer.py:297-330`)."""

    def __init__(self, dim: int, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x0 = x[:, 0::2, 0::2, :]
        x1 = x[:, 1::2, 0::2, :]
        x2 = x[:, 0::2, 1::2, :]
        x3 = x[:, 1::2, 1::2, :]
        return self.reduction(self.norm(torch.cat([x0, x1, x2, x3], dim=-1)))


class BasicLayer(nn.Module):
    """One stage: `blocks` and, except for the last stage, `downsample`."""

    def __init__(self, cfg: SwinConfig, stage: int, compute_dtype: Optional[torch.dtype]):
        super().__init__()
        dim = cfg.num_features[stage]
        dpr = np.linspace(0.0, cfg.drop_path_rate, sum(cfg.depths))
        first = sum(cfg.depths[:stage])
        self.blocks = nn.ModuleList(
            SwinBlock(dim, cfg.num_heads[stage], cfg.window_size,
                      0 if i % 2 == 0 else cfg.window_size // 2,
                      cfg.mlp_ratio, cfg.qkv_bias, compute_dtype, float(dpr[first + i]))
            for i in range(cfg.depths[stage])
        )
        self.downsample = (PatchMerging(dim, compute_dtype)
                           if stage < cfg.num_layers - 1 else None)


def interpolate_mask_nearest(mask: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest-neighbour mask resize as ``F.interpolate(mode='nearest')``
    (`swin_transformer.py:748-752`): src = floor(dst * in / out)."""
    _, in_h, in_w = mask.shape
    ys = (torch.arange(out_h, device=mask.device) * in_h) // out_h
    xs = (torch.arange(out_w, device=mask.device) * in_w) // out_w
    return mask[:, ys][:, :, xs]


class PatchConv(nn.Conv2d):
    """The patch-embed conv: weight [C, 3, ps, ps], computed as
    space-to-depth + matmul like the JAX package (same math as the strided
    conv, and no cuDNN TF32 path in float32)."""

    def __init__(self, in_chans: int, features: int, patch: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_chans, features, patch, stride=patch)
        self.compute_dtype = compute_dtype

    def reset_parameters(self) -> None:
        pass

    def init_weights(self, gen: torch.Generator) -> None:
        fan_in = self.in_channels * self.kernel_size[0] * self.kernel_size[1]
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)
            self.bias.zero_()

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:  # NHWC in and out
        b, h0, w0, cin = pixels.shape
        ps = self.kernel_size[0]
        cd = self.compute_dtype or pixels.dtype
        patches = pixels.to(cd).reshape(b, h0 // ps, ps, w0 // ps, ps, cin)
        patches = patches.permute(0, 1, 3, 2, 4, 5).reshape(b, h0 // ps, w0 // ps, ps * ps * cin)
        # OIHW -> O, (H, W, I) to match the (i, j, c) patch flatten
        kernel = self.weight.to(cd).permute(0, 2, 3, 1).reshape(self.out_channels, -1)
        return F.linear(patches, kernel) + self.bias.to(cd)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: SwinConfig, compute_dtype: Optional[torch.dtype]):
        super().__init__()
        self.proj = PatchConv(cfg.in_chans, cfg.embed_dim, cfg.patch_size, compute_dtype)
        self.norm = LayerNorm(cfg.embed_dim)

    def forward(self, pixels):
        return self.norm(self.proj(pixels))


class SwinTransformer(nn.Module):
    """The full backbone. Input NHWC image + validity mask; output a list of
    (feature [B, h, w, C], mask [B, h, w]) per out_index."""

    def __init__(self, cfg: SwinConfig, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.patch_embed = PatchEmbed(cfg, compute_dtype)
        self.layers = nn.ModuleList(BasicLayer(cfg, s, compute_dtype)
                                    for s in range(cfg.num_layers))
        for s in cfg.out_indices:
            self.add_module(f"norm{s}", LayerNorm(cfg.num_features[s]))

    @property
    def out_channels(self) -> Tuple[int, ...]:
        """Channels of each output level."""
        return tuple(self.cfg.num_features[i] for i in self.cfg.out_indices)

    def forward(self, pixels: torch.Tensor, mask: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        ps = self.cfg.patch_size
        if pixels.shape[1] % ps or pixels.shape[2] % ps:
            raise ValueError(f"image {tuple(pixels.shape[1:3])} is not a multiple of patch {ps}")
        x = self.patch_embed(pixels)
        outs = []
        for stage, layer in enumerate(self.layers):
            for blk in layer.blocks:
                if self.cfg.use_checkpoint:
                    x = checkpoint(blk, x, generator, generator=generator)
                else:
                    x = blk(x, generator)
            if stage in self.cfg.out_indices:
                y = getattr(self, f"norm{stage}")(x)
                lvl_mask = interpolate_mask_nearest(mask, x.shape[1], x.shape[2])
                outs.append((y.to(self.compute_dtype or y.dtype), lvl_mask))
            if layer.downsample is not None:
                x = layer.downsample(x)
        return outs
