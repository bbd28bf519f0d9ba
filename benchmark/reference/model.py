"""The plain reference of the benchmark's configurations: GroundingDINO on a
Swin backbone, with or without the ZiRa branches (the
`dualzerorepbranchgroundingdino` preset), in float32.

A frozen copy of the model's mathematics (IDEA-Research GroundingDINO,
`groundingdino/models/GroundingDINO/*.py`, and ZiRa's
`groundingdino_dual_zero_rep_branch.py`, as the measured port computes
them): Swin -> input projections (+ the ZiRa vision branches) -> BERT ->
feat_map (+ the ZiRa language branch) -> six encoder layers (bi-attention
fusion, text self-attention, deformable attention) -> two-stage query
selection -> six decoder layers -> contrastive class logits and boxes. It
imports no module of the measured program. Parameter names are the
reference checkpoint's, so one state dict loads into both.

Every operation runs in float32; the operands that the configuration
computes in bfloat16 pass `precision.operand(..., low=True)`, which the
control rounds to fp8. MSDA is the plain bilinear gather. Dropout and
stochastic depth draw their masks from the generator handed to `forward`
in the order the measured model draws them (`torch.rand` of the mask's
shape, kept where below 1 - rate), so that one generator gives both the
same masks; a `ShardGenerators` gives each shard of the batch the masks
that a data-parallel rank draws for it. `forward(..., topk_idx=...)`
starts the decoder from the given query selection instead of its own, for
the comparison that follows the program's selection (see
`benchmark/lib/serve.py`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from benchmark.reference.precision import operand

NEG_INF = -1.0e9
ZIRA = "dualzerorepbranchgroundingdino"


@dataclass(frozen=True)
class RefConfig:
    """The sizes of a configuration file (`benchmark/configs/<name>.json`)."""

    modelname: str
    swin: Dict
    bert: Dict
    hidden_dim: int = 256
    nheads: int = 8
    dim_feedforward: int = 2048
    enc_layers: int = 6
    dec_layers: int = 6
    num_queries: int = 900
    num_feature_levels: int = 4
    enc_n_points: int = 4
    dec_n_points: int = 4
    max_text_len: int = 256
    fusion_droppath: float = 0.1
    pe_temperature_h: float = 20.0
    pe_temperature_w: float = 20.0
    loss_adapter_weight: float = 0.1
    zira_lan_scale: float = 0.1
    zira_vis_scale: float = 0.1
    pixel_mean: Tuple[float, ...] = (123.675, 116.28, 103.53)
    pixel_std: Tuple[float, ...] = (58.395, 57.12, 57.375)

    @property
    def zira(self) -> bool:
        return self.modelname == ZIRA

    @staticmethod
    def from_file(conf: Dict) -> "RefConfig":
        m = dict(conf["model"])
        keys = set(RefConfig.__dataclass_fields__) - {"swin", "bert", "modelname"}
        kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in m.items() if k in keys}
        return RefConfig(modelname=conf["modelname"], swin=conf["swin"], bert=conf["bert"],
                         **kw)


# ---------------------------------------------------------------- basics
class ShardGenerators:
    """The generators of a global batch's shards, each of which draws the
    masks of its own images, as data-parallel ranks each draw theirs from a
    generator of their own: a mask's rows are the shards' draws, in order,
    each over as many rows of the batch as its shard holds."""

    def __init__(self, gens, rows: int):
        self.gens, self.rows = list(gens), rows
        self.device = self.gens[0].device

    def rand(self, shape) -> torch.Tensor:
        parts, left = [], shape[0]
        for g in self.gens:
            n = min(self.rows, left)
            if n <= 0:
                break
            parts.append(torch.rand((n,) + tuple(shape[1:]), generator=g, device=g.device))
            left -= n
        return torch.cat(parts)


def draw_keep(shape, rate: float, gen) -> torch.Tensor:
    if isinstance(gen, ShardGenerators):
        return gen.rand(shape) < 1.0 - rate
    return torch.rand(tuple(shape), generator=gen, device=gen.device) < 1.0 - rate


def dropout(x, rate, gen):
    if gen is None or rate == 0.0:
        return x
    return torch.where(draw_keep(x.shape, rate, gen), x / (1.0 - rate), 0.0)


def drop_path(x, rate, gen):
    if gen is None or rate == 0.0:
        return x
    keep = draw_keep((x.shape[0],) + (1,) * (x.dim() - 1), rate, gen)
    return torch.where(keep, x / (1.0 - rate), 0.0)


class Linear(nn.Linear):
    """y = x W^T + b in float32; `low`: the configuration computes it in bf16."""

    def __init__(self, i, o, bias=True, low=True):
        super().__init__(i, o, bias=bias, device="meta")
        self.low = low

    def forward(self, x):
        b = None if self.bias is None else self.bias.float()
        return F.linear(operand(x, self.low), operand(self.weight, self.low), b)


def matmul(a, b, low=True):
    return torch.matmul(operand(a, low), operand(b, low))


def layer_norm(mod: nn.LayerNorm, x):
    return F.layer_norm(x.float(), mod.normalized_shape, mod.weight, mod.bias, mod.eps)


class LayerNorm(nn.LayerNorm):
    def __init__(self, d, eps=1e-5):
        super().__init__(d, eps=eps, device="meta")

    def forward(self, x):
        return layer_norm(self, x)


class MLP(nn.Module):
    def __init__(self, i, h, o, n, low):
        super().__init__()
        dims = [i] + [h] * (n - 1)
        outs = [h] * (n - 1) + [o]
        self.layers = nn.ModuleList(Linear(a, b, low=low) for a, b in zip(dims, outs))

    def forward(self, x):
        for k, layer in enumerate(self.layers):
            x = layer(x)
            if k < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MultiHeadAttention(nn.Module):
    def __init__(self, e, h, low=True):
        super().__init__()
        self.e, self.h, self.low = e, h, low
        self.in_proj_weight = nn.Parameter(torch.empty(3 * e, e, device="meta"))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * e, device="meta"))
        self.out_proj = Linear(e, e, low=low)

    def forward(self, query, key, value, attn_mask=None, key_padding_mask=None):
        e, h = self.e, self.h
        hd = e // h
        w, b = self.in_proj_weight, self.in_proj_bias.float()
        q = F.linear(operand(query, self.low), operand(w[:e], self.low), b[:e])
        k = F.linear(operand(key, self.low), operand(w[e:2 * e], self.low), b[e:2 * e])
        v = F.linear(operand(value, self.low), operand(w[2 * e:], self.low), b[2 * e:])

        def heads(t):
            return t.reshape(t.shape[0], t.shape[1], h, hd).transpose(1, 2)

        q, k, v = heads(q), heads(k), heads(v)
        logits = matmul(q, k.transpose(-1, -2), self.low) * (1.0 / math.sqrt(hd))
        if attn_mask is not None:
            logits = logits.masked_fill(~attn_mask[:, None], NEG_INF)
        if key_padding_mask is not None:
            logits = logits.masked_fill(~key_padding_mask[:, None, None], NEG_INF)
        out = matmul(torch.softmax(logits, -1), v, self.low)
        return self.out_proj(out.transpose(1, 2).reshape(query.shape[0], query.shape[1], e))


def sine_embed(pos, num_feats=128, temperature=10000.0, exchange_xy=True):
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=pos.device)
    dim_t = temperature ** (2.0 * torch.floor(dim_t / 2.0) / num_feats)

    def one(x):
        s = x.float() * (2.0 * math.pi) / dim_t
        return torch.stack((torch.sin(s[..., 0::2]), torch.cos(s[..., 1::2])), -1).flatten(-2)

    parts = [one(pos[..., i:i + 1]) for i in range(pos.shape[-1])]
    if exchange_xy and len(parts) >= 2:
        parts[0], parts[1] = parts[1], parts[0]
    return torch.cat(parts, -1)


def box_sine_embed(pos, num_feats=128):
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=pos.device)
    dim_t = 10000.0 ** (2.0 * torch.floor(dim_t / 2.0) / num_feats)

    def one(c):
        p = c.float()[..., None] * (2.0 * math.pi) / dim_t
        return torch.stack((torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])), -1).flatten(-2)

    x, y = one(pos[..., 0]), one(pos[..., 1])
    if pos.shape[-1] == 2:
        return torch.cat((y, x), -1)
    return torch.cat((y, x, one(pos[..., 2]), one(pos[..., 3])), -1)


def inverse_sigmoid(x, eps=1e-3):
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def box_cxcywh_to_xyxy(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], -1)


def mask_nearest(mask, out_h, out_w):
    _, in_h, in_w = mask.shape
    ys = (torch.arange(out_h, device=mask.device) * in_h) // out_h
    xs = (torch.arange(out_w, device=mask.device) * in_w) // out_w
    return mask[:, ys][:, :, xs]


def conv_nhwc(x, w, b, stride, padding, low=True):
    x, w = operand(x, low), operand(w, low)
    b = None if b is None else b.float()
    if w.shape[2:] == (1, 1) and stride == 1 and padding == 0:
        return F.linear(x, w[:, :, 0, 0], b)
    return F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=stride,
                    padding=padding).permute(0, 2, 3, 1)


class Conv2d(nn.Conv2d):
    def __init__(self, cin, cout, k, stride=1):
        super().__init__(cin, cout, k, stride=stride, padding=k // 2, device="meta")

    def forward(self, x):
        return conv_nhwc(x, self.weight, self.bias, self.stride[0], self.padding[0])


# ---------------------------------------------------------------- Swin
def _rel_index(ws):
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0).copy()
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1).reshape(-1)


def _shift_mask(hp, wp, ws, shift):
    img = np.zeros((hp, wp), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    return np.where(win[:, None, :] - win[:, :, None] != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim, ws, heads):
        super().__init__()
        self.ws, self.heads = ws, heads
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * ws - 1) ** 2, heads, device="meta"))
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x, attn_mask):
        bw, n, c = x.shape
        h = self.heads
        hd = c // h
        idx = torch.as_tensor(_rel_index(self.ws), device=x.device)
        bias = self.relative_position_bias_table[idx].reshape(n, n, h).permute(2, 0, 1)
        qkv = self.qkv(x).reshape(bw, n, 3, h, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        logits = matmul(q * hd ** -0.5, k.transpose(-1, -2)) + bias[None].float()
        if attn_mask is not None:
            nw = attn_mask.shape[0]
            logits = (logits.reshape(bw // nw, nw, h, n, n)
                      + attn_mask[None, :, None]).reshape(bw, h, n, n)
        out = matmul(torch.softmax(logits, -1), v).transpose(1, 2).reshape(bw, n, c)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1, self.fc2 = Linear(dim, hidden), Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class SwinBlock(nn.Module):
    def __init__(self, dim, heads, ws, shift, mlp_ratio, dp):
        super().__init__()
        self.ws, self.shift, self.dp = ws, shift, dp
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, ws, heads)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, gen):
        b, h, w, c = x.shape
        ws, shift = self.ws, self.shift
        shortcut = x
        x = self.norm1(x)
        pb, pr = (ws - h % ws) % ws, (ws - w % ws) % ws
        x = F.pad(x, (0, 0, 0, pr, 0, pb))
        hp, wp = h + pb, w + pr
        mask = None
        if shift > 0:
            x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
            mask = torch.as_tensor(_shift_mask(hp, wp, ws, shift), device=x.device)
        nh, nw = hp // ws, wp // ws
        xw = x.reshape(b, nh, ws, nw, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)
        xw = self.attn(xw, mask)
        x = xw.reshape(b, nh, nw, ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
        if shift > 0:
            x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
        x = shortcut + drop_path(x[:, :h, :w], self.dp, gen)
        return x + drop_path(self.mlp(self.norm2(x)), self.dp, gen)


class PatchMerging(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        _, h, w, _ = x.shape
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x))


class _Stage(nn.Module):
    def __init__(self, blocks, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class PatchEmbed(nn.Module):
    def __init__(self, cin, dim, ps):
        super().__init__()
        self.ps = ps
        self.proj = nn.Conv2d(cin, dim, ps, stride=ps, device="meta")
        self.norm = LayerNorm(dim)

    def forward(self, px):
        b, h, w, c = px.shape
        ps = self.ps
        patches = px.reshape(b, h // ps, ps, w // ps, ps, c).permute(0, 1, 3, 2, 4, 5)
        patches = patches.reshape(b, h // ps, w // ps, ps * ps * c)
        kernel = self.proj.weight.permute(0, 2, 3, 1).reshape(self.proj.out_channels, -1)
        y = F.linear(operand(patches, True), operand(kernel, True)) + self.proj.bias.float()
        return self.norm(y)


class Swin(nn.Module):
    def __init__(self, s: Dict, out_indices=(1, 2, 3)):
        super().__init__()
        dims = [int(s["embed_dim"] * 2 ** i) for i in range(len(s["depths"]))]
        self.dims, self.out_indices = dims, tuple(out_indices)
        self.patch_embed = PatchEmbed(3, s["embed_dim"], s["patch_size"])
        dpr = np.linspace(0.0, s["drop_path_rate"], sum(s["depths"]))
        stages = []
        for st, depth in enumerate(s["depths"]):
            first = sum(s["depths"][:st])
            blocks = [SwinBlock(dims[st], s["num_heads"][st], s["window_size"],
                                0 if i % 2 == 0 else s["window_size"] // 2, s["mlp_ratio"],
                                float(dpr[first + i])) for i in range(depth)]
            down = PatchMerging(dims[st]) if st < len(s["depths"]) - 1 else None
            stages.append(_Stage(blocks, down))
        self.layers = nn.ModuleList(stages)
        for st in self.out_indices:
            self.add_module(f"norm{st}", LayerNorm(dims[st]))

    @property
    def out_channels(self):
        return tuple(self.dims[i] for i in self.out_indices)

    def forward(self, px, mask, gen):
        x = self.patch_embed(px)
        outs = []
        for st, layer in enumerate(self.layers):
            for blk in layer.blocks:
                x = blk(x, gen)
            if st in self.out_indices:
                outs.append((getattr(self, f"norm{st}")(x), mask_nearest(mask, x.shape[1],
                                                                          x.shape[2])))
            if layer.downsample is not None:
                x = layer.downsample(x)
        return outs


# ---------------------------------------------------------------- BERT
class _Emb(nn.Module):
    def __init__(self, b):
        super().__init__()
        d = b["hidden_size"]
        self.word_embeddings = nn.Embedding(b["vocab_size"], d, device="meta")
        self.position_embeddings = nn.Embedding(b["max_position_embeddings"], d, device="meta")
        self.token_type_embeddings = nn.Embedding(b["type_vocab_size"], d, device="meta")
        self.LayerNorm = LayerNorm(d, eps=b["layer_norm_eps"])


class _SelfAttn(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.query, self.key, self.value = Linear(d, d), Linear(d, d), Linear(d, d)


class _DenseNorm(nn.Module):
    def __init__(self, i, o, eps):
        super().__init__()
        self.dense = Linear(i, o)
        self.LayerNorm = LayerNorm(o, eps=eps)

    def forward(self, y, res, rate, gen):
        return self.LayerNorm(res + dropout(self.dense(y), rate, gen))


class _Attn(nn.Module):
    def __init__(self, b):
        super().__init__()
        self.self = _SelfAttn(b["hidden_size"])
        self.output = _DenseNorm(b["hidden_size"], b["hidden_size"], b["layer_norm_eps"])


class _Inter(nn.Module):
    def __init__(self, b):
        super().__init__()
        self.dense = Linear(b["hidden_size"], b["intermediate_size"])


class _BertLayer(nn.Module):
    def __init__(self, b):
        super().__init__()
        self.attention = _Attn(b)
        self.intermediate = _Inter(b)
        self.output = _DenseNorm(b["intermediate_size"], b["hidden_size"], b["layer_norm_eps"])


class _Stack(nn.Module):
    def __init__(self, b):
        super().__init__()
        self.layer = nn.ModuleList(_BertLayer(b) for _ in range(b["num_hidden_layers"]))


class Bert(nn.Module):
    def __init__(self, b: Dict):
        super().__init__()
        self.b = b
        self.embeddings = _Emb(b)
        self.encoder = _Stack(b)

    def forward(self, ids, attn_mask, position_ids, gen):
        b = self.b
        e = self.embeddings
        ids = ids.long()
        x = (e.word_embeddings.weight[ids] + e.position_embeddings.weight[position_ids.long()]
             + e.token_type_embeddings.weight[torch.zeros_like(ids)])
        x = dropout(e.LayerNorm(x), b["hidden_dropout"], gen)
        bias = torch.where(attn_mask[:, None], 0.0, NEG_INF).float()
        nb, t, d = x.shape
        h = b["num_attention_heads"]
        hd = d // h
        for layer in self.encoder.layer:
            sa = layer.attention.self

            def heads(y):
                return y.reshape(nb, t, h, hd).transpose(1, 2)

            q, k, v = heads(sa.query(x)), heads(sa.key(x)), heads(sa.value(x))
            logits = matmul(q, k.transpose(-1, -2)) * hd ** -0.5 + bias
            probs = dropout(torch.softmax(logits, -1), b["attention_dropout"], gen)
            ctx = matmul(probs, v).transpose(1, 2).reshape(nb, t, d)
            x = layer.attention.output(ctx, x, b["hidden_dropout"], gen)
            y = F.gelu(layer.intermediate.dense(x), approximate="none")
            x = layer.output(y, x, b["hidden_dropout"], gen)
        return x


# ---------------------------------------------------------------- ZiRa
def _masked_mean(per, mask=None):
    if mask is None:
        return per.mean()
    m = mask.float()
    while m.dim() < per.dim():
        m = m[..., None]
    return (per * m).sum() / m.expand(per.shape).sum()


def smooth_l1_to_zero(x, mask=None):
    ax = x.float().abs()
    return _masked_mean(torch.where(ax < 1.0, 0.5 * ax * ax, ax - 0.5), mask)


class RepZeroLinear(nn.Module):
    def __init__(self, i, o):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(o, i, device="meta"))
        self.bias = nn.Parameter(torch.empty(o, device="meta"))
        self.scaling = nn.Parameter(torch.empty(1, device="meta"))
        self.freeze_linear = Linear(i, o)

    def forward(self, x, train, mask):
        if not train:
            return self.freeze_linear(x), torch.zeros((), device=x.device)
        branch = self.scaling.float() * F.linear(operand(x, True), operand(self.weight, True),
                                                 self.bias.float())
        out = branch + self.freeze_linear(x)
        return out, smooth_l1_to_zero(branch, mask) + smooth_l1_to_zero(out, mask)


class RepZeroConv(nn.Module):
    def __init__(self, cin, cout, k, stride):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, device="meta"))
        self.bias = nn.Parameter(torch.empty(cout, device="meta"))
        self.scaling = nn.Parameter(torch.empty(1, device="meta"))
        self.freeze_conv = Conv2d(cin, cout, k, stride)

    def forward(self, x, train):
        fc = self.freeze_conv
        if not train:
            return fc(x), None
        branch = self.scaling.float() * conv_nhwc(x, self.weight, self.bias, fc.stride[0],
                                                  fc.padding[0])
        out = branch + fc(x)
        return out, smooth_l1_to_zero(branch) + smooth_l1_to_zero(out)


class InputProj(nn.Sequential):
    def __init__(self, cin, e, k, stride):
        super().__init__(Conv2d(cin, e, k, stride), nn.GroupNorm(32, e, device="meta"))

    def forward(self, x, extra=None):
        y = self[0](x)
        if extra is not None:
            y = y + extra
        gn = self[1]
        return F.group_norm(y.permute(0, 3, 1, 2), 32, gn.weight, gn.bias,
                            gn.eps).permute(0, 2, 3, 1)


# ---------------------------------------------------------------- MSDA
def msda(value, shapes, loc, attn, q_chunk=2048):
    """Plain MSDA: value [B, S, H, D]; loc [B, Q, H, L, P, 2]; attn
    [B, Q, H, L, P] -> [B, Q, H*D], bilinear with zero padding."""
    b, s, h, d = value.shape
    q = loc.shape[1]
    vb = value.transpose(1, 2)
    out = []
    for q0 in range(0, q, q_chunk):
        lc, ac = loc[:, q0:q0 + q_chunk].float(), attn[:, q0:q0 + q_chunk].float()
        qc = lc.shape[1]
        idx_all, w_all = [], []
        start = 0
        for lvl, (hl, wl) in enumerate(shapes):
            x = lc[:, :, :, lvl, :, 0] * wl - 0.5
            y = lc[:, :, :, lvl, :, 1] * hl - 0.5
            x0, y0 = torch.floor(x), torch.floor(y)
            wx1, wy1 = x - x0, y - y0
            a = ac[:, :, :, lvl]
            for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
                xf, yf = x0 + dx, y0 + dy
                ok = (xf >= 0) & (xf < wl) & (yf >= 0) & (yf < hl)
                xi = torch.where(ok, xf, 0.0).long()
                yi = torch.where(ok, yf, 0.0).long()
                wgt = (wx1 if dx else 1.0 - wx1) * (wy1 if dy else 1.0 - wy1)
                idx_all.append(start + yi * wl + xi)
                w_all.append(torch.where(ok, wgt, 0.0) * a)
            start += hl * wl
        idx = torch.stack(idx_all, -1).reshape(b, qc, h, -1).transpose(1, 2)
        wts = torch.stack(w_all, -1).reshape(b, qc, h, -1).transpose(1, 2)
        k = idx.shape[-1]
        g = torch.gather(vb, 2, idx.reshape(b, h, qc * k, 1).expand(b, h, qc * k, d))
        o = torch.einsum("bhqkd,bhqk->bhqd", g.reshape(b, h, qc, k, d), wts)
        out.append(o.transpose(1, 2).reshape(b, qc, h * d))
    return torch.cat(out, 1)


class MSDeformAttn(nn.Module):
    def __init__(self, e, h, levels, points):
        super().__init__()
        self.e, self.h, self.levels, self.points = e, h, levels, points
        self.q_chunk = 2048  # queries a gather takes at once (`GroundingDINO.configure`)
        self.sampling_offsets = Linear(e, h * levels * points * 2, low=False)
        self.attention_weights = Linear(e, h * levels * points, low=False)
        self.value_proj = Linear(e, e)
        self.output_proj = Linear(e, e)

    def forward(self, query, value, ref, shapes, mask):
        h, l, p = self.h, self.levels, self.points
        b, q, _ = query.shape
        s = value.shape[1]
        value = self.value_proj(value)
        if mask is not None:
            value = value.masked_fill(~mask[..., None], 0.0)
        value = operand(value, True).reshape(b, s, h, self.e // h)
        off = self.sampling_offsets(query).reshape(b, q, h, l, p, 2)
        w = torch.softmax(self.attention_weights(query).reshape(b, q, h, l * p), -1)
        w = w.reshape(b, q, h, l, p)
        ref = ref.float()
        if ref.shape[-1] == 2:
            wh = torch.tensor([[w_, h_] for h_, w_ in shapes], dtype=torch.float32,
                              device=query.device)
            loc = ref[:, :, None, :, None, :] + off / wh[None, None, None, :, None, :]
        else:
            loc = ref[:, :, None, :, None, :2] + off / p * ref[:, :, None, :, None, 2:] * 0.5
        return self.output_proj(msda(value, shapes, loc, w, self.q_chunk))


# ---------------------------------------------------------------- encoder
class EncLayer(nn.Module):
    def __init__(self, c: RefConfig):
        super().__init__()
        e = c.hidden_dim
        self.self_attn = MSDeformAttn(e, c.nheads, c.num_feature_levels, c.enc_n_points)
        self.norm1, self.norm2 = LayerNorm(e), LayerNorm(e)
        self.linear1 = Linear(e, c.dim_feedforward)
        self.linear2 = Linear(c.dim_feedforward, e)

    def forward(self, src, pos, ref, shapes, mask):
        src = self.norm1(src + self.self_attn(src + pos, src, ref, shapes, mask))
        return self.norm2(src + self.linear2(F.relu(self.linear1(src))))


class TextLayer(nn.Module):
    def __init__(self, c: RefConfig):
        super().__init__()
        e = c.hidden_dim
        self.self_attn = MultiHeadAttention(e, c.nheads // 2)
        self.norm1, self.norm2 = LayerNorm(e), LayerNorm(e)
        self.linear1 = Linear(e, c.dim_feedforward // 2)
        self.linear2 = Linear(c.dim_feedforward // 2, e)

    def forward(self, text, attn_mask, pos):
        q = text + pos
        text = self.norm1(text + self.self_attn(q, q, text, attn_mask=attn_mask))
        return self.norm2(text + self.linear2(F.relu(self.linear1(text))))


class BiAttn(nn.Module):
    """Image <-> text attention of a fusion layer: both directions share the
    logits; the text's softmax runs over the image tokens."""

    def __init__(self, v_dim, l_dim, e, h):
        super().__init__()
        self.e, self.h = e, h
        self.v_proj, self.l_proj = Linear(v_dim, e), Linear(l_dim, e)
        self.values_v_proj, self.values_l_proj = Linear(v_dim, e), Linear(l_dim, e)
        self.out_v_proj, self.out_l_proj = Linear(e, v_dim), Linear(e, l_dim)

    def forward(self, v, l, mask_v, mask_l):
        h = self.h
        hd = self.e // h

        def heads(t):
            return t.reshape(t.shape[0], t.shape[1], h, hd).transpose(1, 2)

        q_v = heads(self.v_proj(v) * hd ** -0.5)
        k_l = heads(self.l_proj(l))
        val_v, val_l = heads(self.values_v_proj(v)), heads(self.values_l_proj(l))
        logits = matmul(q_v, k_l.transpose(-1, -2))
        attn_l = torch.softmax(logits.masked_fill(~mask_v[:, None, :, None], NEG_INF), -2)
        attn_v = torch.softmax(logits.masked_fill(~mask_l[:, None, None, :], NEG_INF), -1)
        out_v = matmul(attn_v, val_l).transpose(1, 2).reshape(v.shape[0], v.shape[1], self.e)
        out_l = matmul(attn_l.transpose(-1, -2), val_v).transpose(1, 2).reshape(
            l.shape[0], l.shape[1], self.e)
        return self.out_v_proj(out_v), self.out_l_proj(out_l)


class Fusion(nn.Module):
    def __init__(self, c: RefConfig):
        super().__init__()
        e = c.hidden_dim
        self.dp = c.fusion_droppath
        self.layer_norm_v, self.layer_norm_l = LayerNorm(e), LayerNorm(e)
        self.attn = BiAttn(e, e, c.dim_feedforward // 2, c.nheads // 2)
        self.gamma_v = nn.Parameter(torch.empty(e, device="meta"))
        self.gamma_l = nn.Parameter(torch.empty(e, device="meta"))

    def forward(self, v, l, mask_v, mask_l, gen):
        v, l = self.layer_norm_v(v), self.layer_norm_l(l)
        dv, dl = self.attn(v, l, mask_v, mask_l)
        v = v + drop_path(self.gamma_v * dv, self.dp, gen)
        l = l + drop_path(self.gamma_l * dl, self.dp, gen)
        return v, l


def enc_reference_points(shapes, valid_ratios):
    dev = valid_ratios.device
    refs = []
    for lvl, (hl, wl) in enumerate(shapes):
        ry = (torch.arange(hl, dtype=torch.float32, device=dev) + 0.5)[:, None].expand(hl, wl)
        rx = (torch.arange(wl, dtype=torch.float32, device=dev) + 0.5)[None, :].expand(hl, wl)
        ry = ry.reshape(-1)[None] / (valid_ratios[:, None, lvl, 1] * hl)
        rx = rx.reshape(-1)[None] / (valid_ratios[:, None, lvl, 0] * wl)
        refs.append(torch.stack((rx, ry), -1))
    return torch.cat(refs, 1)[:, :, None] * valid_ratios[:, None]


def valid_ratios_of(masks):
    out = []
    for m in masks:
        _, h, w = m.shape
        out.append(torch.stack([m[:, 0, :].float().sum(1) / w, m[:, :, 0].float().sum(1) / h],
                               -1))
    return torch.stack(out, 1)


def output_proposals(memory, mask, shapes):
    b = memory.shape[0]
    dev = memory.device
    props, start = [], 0
    for lvl, (hl, wl) in enumerate(shapes):
        m = mask[:, start:start + hl * wl].reshape(b, hl, wl)
        start += hl * wl
        vh, vw = m[:, :, 0].float().sum(1), m[:, 0, :].float().sum(1)
        gy = torch.arange(hl, dtype=torch.float32, device=dev)[:, None].expand(hl, wl)
        gx = torch.arange(wl, dtype=torch.float32, device=dev)[None, :].expand(hl, wl)
        grid = (torch.stack((gx, gy), -1)[None] + 0.5) / torch.stack([vw, vh], -1).reshape(
            b, 1, 1, 2)
        wh = torch.ones_like(grid) * 0.05 * (2.0 ** lvl)
        props.append(torch.cat((grid, wh), -1).reshape(b, -1, 4))
    p = torch.cat(props, 1)
    valid = ((p > 0.01) & (p < 0.99)).all(-1, keepdim=True)
    p = torch.log(p / (1.0 - p).clamp(min=1e-9))
    keep = mask[..., None] & valid
    return memory.masked_fill(~keep, 0.0), p.masked_fill(~keep, 1.0e6)


# ---------------------------------------------------------------- decoder
class DecLayer(nn.Module):
    def __init__(self, c: RefConfig):
        super().__init__()
        e = c.hidden_dim
        self.self_attn = MultiHeadAttention(e, c.nheads)
        self.norm2 = LayerNorm(e)
        self.ca_text = MultiHeadAttention(e, c.nheads)
        self.catext_norm = LayerNorm(e)
        self.cross_attn = MSDeformAttn(e, c.nheads, c.num_feature_levels, c.dec_n_points)
        self.norm1 = LayerNorm(e)
        self.linear1 = Linear(e, c.dim_feedforward, low=False)
        self.linear2 = Linear(c.dim_feedforward, e, low=False)
        self.norm3 = LayerNorm(e)

    def forward(self, tgt, qpos, ref, memory, mmask, shapes, text, tmask):
        q = tgt + qpos
        tgt = self.norm2(tgt + self.self_attn(q, q, tgt))
        tgt = self.catext_norm(tgt + self.ca_text(tgt + qpos, text, text, key_padding_mask=tmask))
        tgt = self.norm1(tgt + self.cross_attn(tgt + qpos, memory, ref, shapes, mmask))
        return self.norm3(tgt + self.linear2(F.relu(self.linear1(tgt))))


class Encoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.layers = nn.ModuleList(EncLayer(c) for _ in range(c.enc_layers))
        self.text_layers = nn.ModuleList(TextLayer(c) for _ in range(c.enc_layers))
        self.fusion_layers = nn.ModuleList(Fusion(c) for _ in range(c.enc_layers))


class Decoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        e = c.hidden_dim
        self.layers = nn.ModuleList(DecLayer(c) for _ in range(c.dec_layers))
        self.norm = LayerNorm(e)
        self.ref_point_head = MLP(2 * e, e, e, 2, low=True)


class Transformer(nn.Module):
    def __init__(self, c):
        super().__init__()
        e = c.hidden_dim
        self.level_embed = nn.Parameter(torch.empty(c.num_feature_levels, e, device="meta"))
        self.encoder = Encoder(c)
        self.decoder = Decoder(c)
        self.tgt_embed = nn.Embedding(c.num_queries, e, device="meta")
        self.enc_output = Linear(e, e)
        self.enc_output_norm = LayerNorm(e)
        self.enc_out_bbox_embed = MLP(e, e, 4, 3, low=False)


def contrastive(x, text, tmask, max_len):
    res = matmul(x, text.transpose(-1, -2)).masked_fill(~tmask[:, None, :], NEG_INF)
    t = res.shape[-1]
    if t < max_len:
        res = torch.cat([res, res.new_full((*res.shape[:-1], max_len - t), NEG_INF)], -1)
    return res


# ---------------------------------------------------------------- model
class GroundingDINO(nn.Module):
    def __init__(self, c: RefConfig):
        super().__init__()
        self.c = c
        e = c.hidden_dim
        self.bert = Bert(c.bert)
        self.feat_map = Linear(c.bert["hidden_size"], e)
        if c.zira:
            self.rep_linear_adapter = RepZeroLinear(c.bert["hidden_size"], e)
        self.backbone = nn.ModuleList([Swin(c.swin, c.swin.get("out_indices", (1, 2, 3)))])
        chans = self.backbone[0].out_channels
        projs, adapters = [], []
        for lvl in range(c.num_feature_levels):
            if lvl < len(chans):
                cin, k, st = chans[lvl], 1, 1
            else:
                cin, k, st = (chans[-1] if lvl == len(chans) else e), 3, 2
            projs.append(InputProj(cin, e, k, st))
            if c.zira:
                adapters.append(RepZeroConv(cin, e, k, st))
        self.input_proj = nn.ModuleList(projs)
        if c.zira:
            self.input_proj_conv_adapter = nn.ModuleList(adapters)
        self.transformer = Transformer(c)
        head = MLP(e, e, 4, 3, low=False)
        self.bbox_embed = nn.ModuleList([head] * c.dec_layers)
        self.transformer.decoder.bbox_embed = self.bbox_embed
        self.enc_checkpoint = False

    def configure(self, msda_chunk: int = 2048, enc_checkpoint: bool = False) -> "GroundingDINO":
        """How the reference spends memory, not what it computes: the queries
        an MSDA gather takes at once, and whether each deformable encoder
        layer (which draws no random mask) is recomputed in the backward, so
        that the train step fits the card at batch 8."""
        for m in self.modules():
            if isinstance(m, MSDeformAttn):
                m.q_chunk = msda_chunk
        self.enc_checkpoint = enc_checkpoint
        return self

    def forward(self, pixels, mask, text, train=False, gen=None,
                topk_idx: Optional[torch.Tensor] = None) -> Dict:
        """pixels [B, H, W, 3] uint8 or normalized float; mask [B, H, W];
        text: input_ids, text_token_mask, position_ids,
        text_self_attention_masks. Returns pred_logits [B, Q, max_text_len],
        pred_boxes, topk_idx, enc_scores [B, S] (the selection's scores),
        memory_mask; in train mode also aux_outputs, interm_outputs and
        the branches' zero-interference losses."""
        c = self.c
        if pixels.dtype == torch.uint8:
            mean = torch.tensor(c.pixel_mean, device=pixels.device)
            std = torch.tensor(c.pixel_std, device=pixels.device)
            pixels = ((pixels.float() - mean) / std).masked_fill(~mask[..., None], 0.0)
        tmask = text["text_token_mask"]
        bert_out = self.bert(text["input_ids"], text["text_self_attention_masks"],
                             text["position_ids"], gen)
        encoded = self.feat_map(bert_out)
        loss_lin = torch.zeros((), device=pixels.device)
        if c.zira:
            out, loss_lin = self.rep_linear_adapter(bert_out, train, tmask)
            encoded = encoded + out

        feats = self.backbone[0](pixels.float(), mask, gen)
        srcs, masks, poss = [], [], []
        loss_conv = torch.zeros((), device=pixels.device)
        for lvl in range(c.num_feature_levels):
            if lvl < len(feats):
                x, m = feats[lvl]
            else:
                x, m = (feats[-1][0] if lvl == len(feats) else srcs[-1]), None
            extra = None
            if c.zira:
                extra, zil = self.input_proj_conv_adapter[lvl](x, train)
                if train:
                    loss_conv = loss_conv + zil
            src = self.input_proj[lvl](x, extra)
            if m is None:
                m = mask_nearest(mask, src.shape[1], src.shape[2])
            srcs.append(src)
            masks.append(m)
            poss.append(self._sine_pos(m))

        tr = self.transformer
        b = srcs[0].shape[0]
        shapes = tuple((s.shape[1], s.shape[2]) for s in srcs)
        src = torch.cat([s.reshape(b, -1, c.hidden_dim) for s in srcs], 1)
        mflat = torch.cat([m.reshape(b, -1) for m in masks], 1)
        pos = torch.cat([p.reshape(b, -1, c.hidden_dim) + tr.level_embed[i].float()
                         for i, p in enumerate(poss)], 1)
        vr = valid_ratios_of(masks)
        ref = enc_reference_points(shapes, vr)
        pos_text = sine_embed(text["position_ids"][..., None].float(), c.hidden_dim,
                              exchange_xy=False)
        enc = tr.encoder
        txt = encoded
        for i in range(c.enc_layers):
            src, txt = enc.fusion_layers[i](src, txt, mflat, tmask, gen)
            txt = enc.text_layers[i](txt, text["text_self_attention_masks"], pos_text)
            if self.enc_checkpoint and torch.is_grad_enabled():
                src = torch.utils.checkpoint.checkpoint(enc.layers[i], src, pos, ref, shapes,
                                                        mflat, use_reentrant=False)
            else:
                src = enc.layers[i](src, pos, ref, shapes, mflat)
        memory = src

        om, props, scores = self.selection_scores(memory, txt, mflat, shapes, tmask)
        enc_coords = tr.enc_out_bbox_embed(om) + props
        if topk_idx is None:
            topk_idx = torch.sort(scores, dim=1, descending=True, stable=True).indices[
                :, :c.num_queries]
        refp = torch.gather(enc_coords, 1, topk_idx[..., None].expand(-1, -1, 4))
        tgt = tr.tgt_embed.weight[None].expand(b, -1, -1).float()

        dec = tr.decoder
        out = tgt
        rp = torch.sigmoid(refp.detach())
        hs, refs = [], [rp]
        for i, layer in enumerate(dec.layers):
            ref_in = rp[:, :, None] * torch.cat([vr, vr], -1)[:, None]
            qpos = dec.ref_point_head(box_sine_embed(ref_in[:, :, 0, :], c.hidden_dim // 2))
            out = layer(out, qpos, ref_in, memory, mflat, shapes, txt, tmask)
            new = torch.sigmoid(self.bbox_embed[i](out) + inverse_sigmoid(rp))
            rp = new.detach()
            refs.append(new)
            hs.append(dec.norm(out))
        layers = range(len(hs)) if train else (len(hs) - 1,)
        boxes = {i: torch.sigmoid(self.bbox_embed[i](hs[i]) + inverse_sigmoid(refs[i]))
                 for i in layers}
        logits = {i: contrastive(hs[i], txt, tmask, c.max_text_len) for i in layers}
        last = len(hs) - 1
        res = {"pred_logits": logits[last], "pred_boxes": boxes[last], "topk_idx": topk_idx,
               "enc_scores": scores, "memory_mask": mflat, "memory": memory,
               "memory_text": txt, "shapes": shapes}
        if train:
            sel = torch.gather(om, 1, topk_idx[..., None].expand(-1, -1, om.shape[-1]))
            res["aux_outputs"] = [{"pred_logits": logits[i], "pred_boxes": boxes[i]}
                                  for i in range(last)]
            res["interm_outputs"] = {"pred_logits": contrastive(sel, txt, tmask, c.max_text_len),
                                     "pred_boxes": torch.sigmoid(refp)}
            res["loss_linear_adapter"] = loss_lin
            res["loss_conv_adapter"] = loss_conv
        return res

    def selection_scores(self, memory, txt, mflat, shapes, tmask):
        """The two-stage head on the encoder's memory: (its normed output
        memory, the unsigmoided proposals, each token's selection score, the
        max over the text tokens of its contrastive logits)."""
        tr = self.transformer
        om, props = output_proposals(memory, mflat, shapes)
        om = tr.enc_output_norm(tr.enc_output(om))
        return om, props, contrastive(om, txt, tmask, self.c.max_text_len).amax(-1)

    def _sine_pos(self, m):
        c = self.c
        n = c.hidden_dim // 2
        nm = m.float()
        y = torch.cumsum(nm, 1)
        x = torch.cumsum(nm, 2)
        y = y / (y[:, -1:, :] + 1e-6) * 2 * math.pi
        x = x / (x[:, :, -1:] + 1e-6) * 2 * math.pi
        dt = torch.arange(n, dtype=torch.float32, device=m.device)
        dtx = c.pe_temperature_w ** (2.0 * torch.floor(dt / 2.0) / n)
        dty = c.pe_temperature_h ** (2.0 * torch.floor(dt / 2.0) / n)
        px, py = x[..., None] / dtx, y[..., None] / dty
        px = torch.stack((torch.sin(px[..., 0::2]), torch.cos(px[..., 1::2])), -1).flatten(-2)
        py = torch.stack((torch.sin(py[..., 0::2]), torch.cos(py[..., 1::2])), -1).flatten(-2)
        return torch.cat((py, px), -1)


def build(c: RefConfig, device) -> GroundingDINO:
    """The reference with empty float32 parameters on `device`, to be
    filled by `load_state_dict`."""
    with torch.device("meta"):
        m = GroundingDINO(c)
    return m.to_empty(device=device).eval()


def state_shapes(c: RefConfig) -> Dict[str, Tuple[int, ...]]:
    """{state dict key: shape}, aliases included (the reference checkpoint's
    keys)."""
    with torch.device("meta"):
        m = GroundingDINO(c)
    return {k: tuple(v.shape) for k, v in m.state_dict().items()}


def per_category(token_logits: torch.Tensor, c2t: torch.Tensor, fill=-100.0) -> torch.Tensor:
    """[B, Q, T'] token logits, [B, C, T] category masks -> [B, Q, C]: the
    max over each category's tokens, `fill` for a category with none."""
    t = c2t.shape[-1]
    masked = torch.where(c2t[:, None], token_logits[:, :, None, :t], -float("inf"))
    out = masked.amax(-1)
    return torch.where(c2t.any(-1)[:, None], out, torch.full_like(out, fill))


def detections(cls_logits, boxes, orig_sizes, k):
    """Global top-k over (query x category), boxes scaled to the original
    image (xyxy pixels, clipped): (scores, labels, boxes), each [B, K]."""
    b, q, c = cls_logits.shape
    prob = torch.sigmoid(cls_logits.float()).reshape(b, q * c)
    k = min(k, q * c)
    scores, idx = torch.sort(prob, dim=1, descending=True, stable=True)
    scores, idx = scores[:, :k], idx[:, :k]
    sel = torch.gather(boxes, 1, (idx // c)[..., None].expand(-1, -1, 4))
    xyxy = box_cxcywh_to_xyxy(sel.float())
    h, w = orig_sizes[:, 0:1].float(), orig_sizes[:, 1:2].float()
    scale = torch.cat([w, h, w, h], -1)[:, None]
    return scores, idx % c, torch.minimum((xyxy * scale).clamp(min=0.0), scale)
