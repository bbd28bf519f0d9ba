"""Feature-enhancer encoder + cross-modality decoder, the port of
the JAX package's `models/transformer.py` (reference
`transformer_for_adapter.py`): `MSDeformAttn`, the deformable encoder and
text-enhancer layers, `FeatureEnhancer`, two-stage language-guided top-k
query selection, the decoder layer, `CrossModalityDecoder` and
`Transformer`. Under `use_adapter` (CAT) each deformable layer holds an
in-layer `adapters.Adapter`; each layer returns its adapter's f32 loss (0
without an adapter), and the stacks and `Transformer` sum them as the JAX
package does.

The JAX model's switches: without `use_text_enhancer` the encoder has no
text layers, without `use_fusion_layer` no fusion layers, without
`use_text_cross_attention` the decoder layers have no text cross-attention
(a switched-off part builds no parameters); without `embed_init_tgt` the
decoder starts from the selected encoder memory, detached.
`use_transformer_ckpt` recomputes each deformable encoder layer in the
backward and `use_checkpoint` each fusion layer (`models/remat.py`).

Batch-first; masks True = valid; softmaxes in f32; the decoder FFN in f32 as
in the reference's autocast-disabled region (`:1004`). MSDA goes straight to
`ops.msda.ms_deform_attn`, which runs the CUDA kernels on the card. Dropout
draws from the generator given to `forward`, and is off without one.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ziragroundingdino_torch.config import GroundingDINOConfig
from ziragroundingdino_torch.device import device_constant
from ziragroundingdino_torch.models.adapters import Adapter, zero_loss
from ziragroundingdino_torch.models.fusion import BiAttentionBlock
from ziragroundingdino_torch.models.heads import ContrastiveEmbed
from ziragroundingdino_torch.models.layers import (
    MLP,
    Embedding,
    LayerNorm,
    Linear,
    MultiHeadAttention,
    activation_fn,
    gen_sineembed_for_position,
    get_sine_pos_embed,
)
from ziragroundingdino_torch.models.remat import checkpoint
from ziragroundingdino_torch.ops.box_ops import inverse_sigmoid
from ziragroundingdino_torch.ops.msda import ms_deform_attn
from ziragroundingdino_torch.parallel import pp, sp
from ziragroundingdino_torch.utils import profiling

SpatialShapes = Tuple[Tuple[int, int], ...]


class _SamplingOffsets(Linear):
    """Zero weight; bias = per-head compass directions scaled by point index
    (`ms_deform_attn.py:203-217`)."""

    def __init__(self, d_model: int, n_heads: int, n_levels: int, n_points: int):
        super().__init__(d_model, n_heads * n_levels * n_points * 2,
                         compute_dtype=torch.float32)
        self.shape = (n_heads, n_levels, n_points)

    def init_weights(self, gen: torch.Generator) -> None:
        h, l, p = self.shape
        thetas = np.arange(h, dtype=np.float32) * (2.0 * np.pi / h)
        grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
        grid = grid / np.abs(grid).max(-1, keepdims=True)
        grid = np.tile(grid[:, None, None, :], (1, l, p, 1))
        for i in range(p):
            grid[:, :, i, :] *= i + 1
        with torch.no_grad():
            self.weight.zero_()
            self.bias.copy_(torch.from_numpy(grid.reshape(-1)))


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention module (`ms_deform_attn.py:133-354`)."""

    def __init__(self, embed_dim: int = 256, num_heads: int = 8, num_levels: int = 4,
                 num_points: int = 4, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.num_levels, self.num_points = num_levels, num_points
        self.compute_dtype = compute_dtype
        self.sampling_offsets = _SamplingOffsets(embed_dim, num_heads, num_levels, num_points)
        self.attention_weights = Linear(embed_dim, num_heads * num_levels * num_points,
                                        compute_dtype=torch.float32, init="zeros")
        self.value_proj = Linear(embed_dim, embed_dim, compute_dtype=compute_dtype, init="xavier")
        self.output_proj = Linear(embed_dim, embed_dim, compute_dtype=compute_dtype, init="xavier")

    def forward(
        self,
        query: torch.Tensor,  # [B, Q, E] (pos already added)
        value: torch.Tensor,  # [B, S, E]
        reference_points: torch.Tensor,  # [B, Q, L, 2] or [B, Q, L, 4] in [0, 1]
        spatial_shapes: SpatialShapes,
        key_padding_mask: Optional[torch.Tensor] = None,  # [B, S] True = valid
        shard: Optional[sp.TokenShard] = None,
    ) -> torch.Tensor:
        """`shard`: the encoder's tokens under sequence parallelism (query,
        reference points, value and mask are this rank's chunk of them). In
        a `sequence_parallel` context without one (the decoder), the
        queries are split over the seq ranks here and the output gathered,
        the value whole (`parallel.sp.msda_query_sharded`)."""
        h, l, p = self.num_heads, self.num_levels, self.num_points
        gather_out = shard is None and sp.active_mesh() is not None
        if gather_out:
            shard = sp.TokenShard(query.shape[1], query.device)
            query, reference_points = shard.take(query), shard.take(reference_points)
        b, q, _ = query.shape
        s = value.shape[1]
        value = self.value_proj(value)
        if key_padding_mask is not None:
            value = value.masked_fill(~key_padding_mask[..., None], 0.0)
        value = value.reshape(b, s, h, self.embed_dim // h)

        offsets = self.sampling_offsets(query).reshape(b, q, h, l, p, 2)
        weights = self.attention_weights(query).reshape(b, q, h, l * p)
        weights = torch.softmax(weights.float(), dim=-1).reshape(b, q, h, l, p)

        ref = reference_points.float()
        if ref.shape[-1] == 2:
            # offsets are normalized by each level's (w, h)
            wh = device_constant(tuple((int(w_), int(h_)) for h_, w_ in spatial_shapes),
                                 query.device)
            loc = ref[:, :, None, :, None, :] + offsets / wh[None, None, None, :, None, :]
        else:
            loc = (ref[:, :, None, :, None, :2]
                   + offsets / p * ref[:, :, None, :, None, 2:] * 0.5)
        if shard is None:
            out = ms_deform_attn(value.contiguous(), spatial_shapes, loc.contiguous(),
                                 weights.contiguous())
        else:
            out = sp.msda_query_sharded(value, spatial_shapes, loc, weights, shard,
                                        value_sharded=not gather_out)
        out = self.output_proj(out)
        return shard.gather(out) if gather_out else out


class DeformableEncoderLayer(nn.Module):
    """`transformer_for_adapter.py:809-907`; the CAT adapter reads the
    normed attention output and adds beside the FFN, before `norm2`, in the
    compute dtype (`:850`)."""

    def __init__(self, cfg: GroundingDINOConfig, compute_dtype: Optional[torch.dtype]):
        super().__init__()
        e = cfg.hidden_dim
        self.self_attn = MSDeformAttn(e, cfg.nheads, cfg.num_feature_levels, cfg.enc_n_points,
                                      compute_dtype)
        self.norm1 = LayerNorm(e)
        self.linear1 = Linear(e, cfg.dim_feedforward, compute_dtype=compute_dtype)
        self.linear2 = Linear(cfg.dim_feedforward, e, compute_dtype=compute_dtype)
        self.norm2 = LayerNorm(e)
        self.act = activation_fn(cfg.transformer_activation)
        self.adapter = (Adapter(e, 64, cfg.encoder_gate_base_scale, cfg.use_self_kd,
                                compute_dtype=compute_dtype) if cfg.use_adapter else None)

    def forward(self, src, pos, reference_points, spatial_shapes, key_padding_mask, shard=None):
        """(src, the adapter's f32 loss, 0 without one); `shard`: the
        tokens' `sp.TokenShard` under sequence parallelism."""
        src2 = self.self_attn(src + pos, src, reference_points, spatial_shapes, key_padding_mask,
                              shard)
        src = self.norm1(src + src2).to(src2.dtype)
        adapter_out, loss = (self.adapter(src, shard) if self.adapter is not None
                             else (None, zero_loss(src)))
        y = self.linear2(self.act(self.linear1(src)))
        src = src + y
        if adapter_out is not None:
            src = src + adapter_out
        return self.norm2(src).to(y.dtype), loss


class TextEnhancerLayer(nn.Module):
    """Vanilla transformer encoder layer over text (`transformer_vanilla.py:
    72-123`): nheads//2 heads, ffn//2 wide, relu."""

    def __init__(self, cfg: GroundingDINOConfig, compute_dtype: Optional[torch.dtype]):
        super().__init__()
        e = cfg.hidden_dim
        self.self_attn = MultiHeadAttention(e, cfg.nheads // 2, compute_dtype, cfg.text_dropout)
        self.norm1 = LayerNorm(e)
        self.linear1 = Linear(e, cfg.dim_feedforward // 2, compute_dtype=compute_dtype)
        self.linear2 = Linear(cfg.dim_feedforward // 2, e, compute_dtype=compute_dtype)
        self.norm2 = LayerNorm(e)

    def forward(self, text, attn_mask, pos, generator=None):
        q = text if pos is None else text + pos
        attn = self.self_attn(q, q, text, attn_mask=attn_mask, generator=generator)
        text = self.norm1(text + attn).to(attn.dtype)
        y = self.linear2(torch.relu(self.linear1(text)))
        return self.norm2(text + y).to(y.dtype)


def encoder_reference_points(spatial_shapes: SpatialShapes,
                             valid_ratios: torch.Tensor) -> torch.Tensor:
    """Per-pixel normalized reference points (`transformer_for_adapter.py:
    483-498`). valid_ratios [B, L, 2] (w, h). Returns [B, S, L, 2]."""
    dev = valid_ratios.device
    refs = []
    for lvl, (h_l, w_l) in enumerate(spatial_shapes):
        ry = (torch.arange(h_l, dtype=torch.float32, device=dev) + 0.5)[:, None].expand(h_l, w_l)
        rx = (torch.arange(w_l, dtype=torch.float32, device=dev) + 0.5)[None, :].expand(h_l, w_l)
        ry = ry.reshape(-1)[None] / (valid_ratios[:, None, lvl, 1] * h_l)
        rx = rx.reshape(-1)[None] / (valid_ratios[:, None, lvl, 0] * w_l)
        refs.append(torch.stack((rx, ry), -1))
    ref = torch.cat(refs, dim=1)
    return ref[:, :, None] * valid_ratios[:, None]


def compute_valid_ratios(masks: Sequence[torch.Tensor]) -> torch.Tensor:
    """[B, L, 2] (w, h) valid fractions per level (`transformer_for_adapter.py:
    216-224`); masks per level [B, h, w] True = valid."""
    ratios = []
    for m in masks:
        _, h, w = m.shape
        valid_h = m[:, :, 0].float().sum(1)
        valid_w = m[:, 0, :].float().sum(1)
        ratios.append(torch.stack([valid_w / w, valid_h / h], -1))
    return torch.stack(ratios, dim=1)


def gen_encoder_output_proposals(
    memory: torch.Tensor,  # [B, S, E]
    memory_mask: torch.Tensor,  # [B, S] True = valid
    spatial_shapes: SpatialShapes,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Anchor proposals per memory pixel (`utils.py:56-116`). Returns (masked
    memory, unsigmoided proposals [B, S, 4]); invalid positions get the large
    finite logit 1e6, as in the JAX package."""
    b = memory.shape[0]
    dev = memory.device
    proposals = []
    start = 0
    for lvl, (h_l, w_l) in enumerate(spatial_shapes):
        m = memory_mask[:, start:start + h_l * w_l].reshape(b, h_l, w_l)
        start += h_l * w_l
        valid_h = m[:, :, 0].float().sum(1)
        valid_w = m[:, 0, :].float().sum(1)
        gy = torch.arange(h_l, dtype=torch.float32, device=dev)[:, None].expand(h_l, w_l)
        gx = torch.arange(w_l, dtype=torch.float32, device=dev)[None, :].expand(h_l, w_l)
        grid = torch.stack((gx, gy), -1)
        scale = torch.stack([valid_w, valid_h], -1).reshape(b, 1, 1, 2)
        grid = (grid[None] + 0.5) / scale
        wh = torch.ones_like(grid) * 0.05 * (2.0 ** lvl)
        proposals.append(torch.cat((grid, wh), -1).reshape(b, -1, 4))
    props = torch.cat(proposals, dim=1).float()
    valid = ((props > 0.01) & (props < 0.99)).all(-1, keepdim=True)
    props = torch.log(props / (1.0 - props).clamp(min=1e-9))
    keep = memory_mask[..., None] & valid
    props = props.masked_fill(~keep, 1.0e6)
    mem = memory.masked_fill(~keep, 0.0)
    return mem, props


def select_topk(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores per row [B, S] -> [B, k], ties to the
    lower index (`jax.lax.top_k`). With fewer than k positions, all of them
    are taken in order and cycled (`transformer.py:546-550` of the JAX
    package)."""
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    s_total = scores.shape[1]
    if s_total >= k:
        return order[:, :k]
    reps = -(-k // s_total)
    return order.repeat(1, reps)[:, :k]


def _in_span(name: str, fn):
    """`fn`, run inside `profiling.span(name)`."""

    def run(*args):
        with profiling.span(name):
            return fn(*args)

    return run


class FeatureEnhancer(nn.Module):
    """The encoder stack: per layer fusion -> text layer -> deformable layer
    (`transformer_for_adapter.py:563-661`), the first two where the config
    has them. Returns (image memory, text memory, the layers' summed f32
    adapter loss). In a `parallel.sp.sequence_parallel` context each seq
    rank runs the layers on its chunk of the tokens, and the memory is
    gathered once after the last layer; in a `parallel.pp.pipeline_parallel`
    one each pipe rank runs its stage's layers on microbatches."""

    def __init__(self, cfg: GroundingDINOConfig, compute_dtype: Optional[torch.dtype]):
        super().__init__()
        self.cfg = cfg
        n = cfg.enc_layers
        self.layers = nn.ModuleList(DeformableEncoderLayer(cfg, compute_dtype) for _ in range(n))
        self.text_layers = (nn.ModuleList(TextEnhancerLayer(cfg, compute_dtype) for _ in range(n))
                            if cfg.use_text_enhancer else None)
        self.fusion_layers = nn.ModuleList(
            BiAttentionBlock(cfg.hidden_dim, cfg.hidden_dim, cfg.dim_feedforward // 2,
                             cfg.nheads // 2, compute_dtype=compute_dtype,
                             dropout=cfg.fusion_dropout, drop_path=cfg.fusion_droppath)
            for _ in range(n)) if cfg.use_fusion_layer else None
        # `profiling.span` names of layer i's fusion, text and deformable
        # layers (inside remat's checkpoint: a recompute is a span too)
        self.span_names = [(f"encoder.fusion.{i}", f"encoder.text.{i}", f"encoder.deform.{i}")
                           for i in range(n)]

    def layer_step(self, i, src, text, pos, reference_points, spatial_shapes, key_padding_mask,
                   text_token_mask, text_self_attention_masks, pos_text, generator=None,
                   shard=None):
        """Encoder layer i: fusion -> text layer -> deformable layer, each
        recomputed in the backward where the config says; (src, text, the
        layer's adapter loss). The sequential loop and a pipeline stage
        (`parallel/pp.py`) both run it."""
        cfg = self.cfg
        fusion_name, text_name, deform_name = self.span_names[i]
        if self.fusion_layers is not None:
            args = (src, text, key_padding_mask, text_token_mask, generator, shard)
            fusion = _in_span(fusion_name, self.fusion_layers[i])
            src, text = (checkpoint(fusion, *args, generator=generator)
                         if cfg.use_checkpoint else fusion(*args))
        if self.text_layers is not None:
            with profiling.span(text_name):
                text = self.text_layers[i](text, text_self_attention_masks, pos_text, generator)
        args = (src, pos, reference_points, spatial_shapes, key_padding_mask, shard)
        layer = _in_span(deform_name, self.layers[i])
        src, loss = checkpoint(layer, *args) if cfg.use_transformer_ckpt else layer(*args)
        return src, text, loss

    def forward(self, src, pos, spatial_shapes, valid_ratios, key_padding_mask, text,
                text_token_mask, text_self_attention_masks, position_ids, generator=None):
        cfg = self.cfg
        reference_points = encoder_reference_points(spatial_shapes, valid_ratios)
        pos_text = None
        if self.text_layers is not None:
            pos_text = get_sine_pos_embed(position_ids[..., None].float(),
                                          num_pos_feats=cfg.hidden_dim,
                                          exchange_xy=False).to(src.dtype)
        # under pipeline_parallel (parallel/pp.py): GPipe the layers over the
        # mesh's pipe axis in place of the loop below, as JAX's `:306-315`
        if pp.active() is not None:
            return pp.pipelined_enhancer(self, src, pos, reference_points, spatial_shapes,
                                         key_padding_mask, text, text_token_mask,
                                         text_self_attention_masks, pos_text, generator)
        shard = sp.token_shard(src.shape[1], src.device)
        if shard is not None:
            src, pos, reference_points = (shard.take(t) for t in (src, pos, reference_points))
            key_padding_mask = shard.take_mask(key_padding_mask)
        adapter_loss = zero_loss(src)
        for i in range(cfg.enc_layers):
            src, text, loss = self.layer_step(i, src, text, pos, reference_points, spatial_shapes,
                                              key_padding_mask, text_token_mask,
                                              text_self_attention_masks, pos_text, generator,
                                              shard)
            adapter_loss = adapter_loss + loss
        if shard is not None:
            src = shard.gather(src)
        return src, text, adapter_loss


class DeformableDecoderLayer(nn.Module):
    """`transformer_for_adapter.py:910-1073`: self-attn -> text cross-attn ->
    deformable cross-attn -> f32 FFN. The CAT adapter reads the normed
    cross-attention output and adds after the FFN, before `norm3`, in f32
    (`:969`)."""

    def __init__(self, cfg: GroundingDINOConfig, compute_dtype: Optional[torch.dtype]):
        super().__init__()
        e = cfg.hidden_dim
        self.compute_dtype = compute_dtype
        self.self_attn = MultiHeadAttention(e, cfg.nheads, compute_dtype, cfg.dropout)
        self.norm2 = LayerNorm(e)
        if cfg.use_text_cross_attention:
            self.ca_text = MultiHeadAttention(e, cfg.nheads, compute_dtype, cfg.dropout)
            self.catext_norm = LayerNorm(e)
        else:
            self.ca_text = self.catext_norm = None
        self.cross_attn = MSDeformAttn(e, cfg.nheads, cfg.num_feature_levels, cfg.dec_n_points,
                                       compute_dtype)
        self.norm1 = LayerNorm(e)
        self.linear1 = Linear(e, cfg.dim_feedforward, compute_dtype=torch.float32)
        self.linear2 = Linear(cfg.dim_feedforward, e, compute_dtype=torch.float32)
        self.norm3 = LayerNorm(e)
        self.act = activation_fn(cfg.transformer_activation)
        self.adapter = (Adapter(e, 64, cfg.decoder_gate_base_scale, cfg.use_self_kd,
                                compute_dtype=torch.float32) if cfg.use_adapter else None)

    def forward(self, tgt, query_pos, reference_points_input, memory, memory_mask,
                spatial_shapes, text, text_token_mask, self_attn_mask=None, generator=None):
        """(tgt, the adapter's f32 loss, 0 without one)."""
        q = tgt + query_pos
        attn = self.self_attn(q, q, tgt, attn_mask=self_attn_mask, generator=generator)
        tgt = self.norm2(tgt + attn).to(attn.dtype)
        if self.ca_text is not None:
            attn = self.ca_text(tgt + query_pos, text, text, key_padding_mask=text_token_mask,
                                generator=generator)
            tgt = self.catext_norm(tgt + attn).to(attn.dtype)
        attn = self.cross_attn(tgt + query_pos, memory, reference_points_input, spatial_shapes,
                               memory_mask)
        tgt = self.norm1(tgt + attn).to(attn.dtype)
        adapter_out, loss = (self.adapter(tgt) if self.adapter is not None
                             else (None, zero_loss(tgt)))
        y = self.linear2(self.act(self.linear1(tgt)))
        tgt = tgt.float() + y
        if adapter_out is not None:
            tgt = tgt + adapter_out
        return self.norm3(tgt).to(self.compute_dtype or y.dtype), loss


class CrossModalityDecoder(nn.Module):
    """Decoder stack with conditional queries + iterative box refinement
    (`transformer_for_adapter.py:665-806`). The shared box and class heads
    are owned by the parent model and aliased here as `bbox_embed` and
    `class_embed`, as in the reference (`groundingdino.py:188-200`)."""

    def __init__(self, cfg: GroundingDINOConfig, compute_dtype: Optional[torch.dtype]):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        e = cfg.hidden_dim
        self.layers = nn.ModuleList(DeformableDecoderLayer(cfg, compute_dtype)
                                    for _ in range(cfg.dec_layers))
        self.span_names = [f"decoder.layer.{i}" for i in range(cfg.dec_layers)]
        self.norm = LayerNorm(e)
        self.ref_point_head = MLP(2 * e, e, e, 2, compute_dtype=compute_dtype)
        # the parent model's shared heads (`bbox_embed` is read here)
        self.bbox_embed: Optional[nn.ModuleList] = None
        self.class_embed: Optional[nn.ModuleList] = None

    def forward(self, tgt, refpoints_unsigmoid, memory, memory_mask, spatial_shapes,
                valid_ratios, text, text_token_mask, generator=None):
        cfg = self.cfg
        output = tgt
        reference_points = torch.sigmoid(refpoints_unsigmoid.float())
        intermediate: List[torch.Tensor] = []
        ref_points = [reference_points]
        adapter_loss = zero_loss(output)
        for i, layer in enumerate(self.layers):
            with profiling.span(self.span_names[i]):
                ref_input = (reference_points[:, :, None]
                             * torch.cat([valid_ratios, valid_ratios], -1)[:, None])  # [B,Q,L,4]
                query_sine = gen_sineembed_for_position(ref_input[:, :, 0, :],
                                                        num_feats=cfg.hidden_dim // 2)
                query_pos = self.ref_point_head(query_sine.to(self.compute_dtype or output.dtype))
                output, loss = layer(output, query_pos, ref_input, memory, memory_mask,
                                     spatial_shapes, text, text_token_mask, generator=generator)
                adapter_loss = adapter_loss + loss
                delta = self.bbox_embed[i](output.float()).float()
                new_ref = torch.sigmoid(delta + inverse_sigmoid(reference_points))
                reference_points = new_ref.detach()
                ref_points.append(new_ref)
                intermediate.append(self.norm(output))
        return intermediate, ref_points, adapter_loss


class Transformer(nn.Module):
    """Encoder-decoder with two-stage language-guided query selection
    (`transformer_for_adapter.py:228-421`). Under `use_cls_linear` and
    without `two_stage_class_embed_share` the two-stage class head is its
    own `enc_out_class_embed` with its own `cls_linear`
    (`groundingdino.py:380-388` of the JAX package); else the model's
    shared head serves it."""

    def __init__(self, cfg: GroundingDINOConfig, compute_dtype: Optional[torch.dtype]):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        e = cfg.hidden_dim
        self.level_embed = nn.Parameter(torch.empty(cfg.num_feature_levels, e))
        self.encoder = FeatureEnhancer(cfg, compute_dtype)
        self.decoder = CrossModalityDecoder(cfg, compute_dtype)
        self.tgt_embed = Embedding(cfg.num_queries, e, std=1.0) if cfg.embed_init_tgt else None
        self.enc_output = Linear(e, e, compute_dtype=compute_dtype)
        self.enc_output_norm = LayerNorm(e)
        self.enc_out_bbox_embed = MLP(e, e, 4, 3, zero_init_last=True,
                                      compute_dtype=torch.float32)
        self.enc_out_class_embed = (
            ContrastiveEmbed(cfg.max_text_len, True, e, compute_dtype)
            if cfg.use_cls_linear and not cfg.two_stage_class_embed_share else None)

    def init_weights(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.level_embed.normal_(0.0, 1.0, generator=gen)

    def forward(self, srcs, masks, pos_embeds, text_dict, enc_class_embed, generator=None,
                train=False):
        """srcs/pos_embeds per level [B, h, w, E], masks per level [B, h, w]
        True = valid; enc_class_embed: (memory, text_dict) -> [B, S, T].
        With `train`, the output adds the two-stage heads' inputs.
        `adapter_loss` is the in-layer adapters' summed f32 loss, 0 without
        them."""
        cfg = self.cfg
        b = srcs[0].shape[0]
        cd = self.compute_dtype or srcs[0].dtype
        src_flat, mask_flat, pos_flat, shapes = [], [], [], []
        for lvl, (src, mask, pos) in enumerate(zip(srcs, masks, pos_embeds)):
            _, h, w, e = src.shape
            shapes.append((h, w))
            src_flat.append(src.reshape(b, h * w, e))
            mask_flat.append(mask.reshape(b, h * w))
            pos_flat.append(pos.reshape(b, h * w, e).to(cd) + self.level_embed[lvl].to(cd))
        src_flat = torch.cat(src_flat, 1)
        mask_flat = torch.cat(mask_flat, 1)
        pos_flat = torch.cat(pos_flat, 1)
        spatial_shapes = tuple(shapes)
        valid_ratios = compute_valid_ratios(masks)

        profiling.mark("encoder")
        memory, memory_text, enc_loss = self.encoder(
            src_flat, pos_flat, spatial_shapes, valid_ratios, mask_flat,
            text_dict["encoded_text"], text_dict["text_token_mask"],
            text_dict["text_self_attention_masks"], text_dict["position_ids"], generator)
        profiling.mark("decoder")
        text_dict = dict(text_dict, encoded_text=memory_text)

        # two-stage query selection (`transformer_for_adapter.py:301-344`)
        output_memory, output_proposals = gen_encoder_output_proposals(
            memory, mask_flat, spatial_shapes)
        output_memory = self.enc_output_norm(self.enc_output(output_memory)).to(cd)
        enc_logits = enc_class_embed(output_memory, text_dict)
        enc_coords = self.enc_out_bbox_embed(output_memory.float()).float() + output_proposals
        topk_idx = select_topk(enc_logits.amax(-1), cfg.num_queries)

        # the decoder starts from detached anchors
        # (`transformer_for_adapter.py:331`, `transformer.py:555` of the JAX
        # package); only the encoder-output heads (`hs_enc`, `ref_enc`) carry
        # the two-stage losses back into the encoder
        refpoint_undetached = torch.gather(enc_coords, 1, topk_idx[..., None].expand(-1, -1, 4))
        e = output_memory.shape[-1]
        selected = (torch.gather(output_memory, 1, topk_idx[..., None].expand(-1, -1, e))
                    if train or self.tgt_embed is None else None)
        if self.tgt_embed is not None:
            tgt = self.tgt_embed.weight[None].expand(b, -1, -1).to(cd)
        else:  # the selected encoder outputs, detached (`transformer.py:563-569` there)
            tgt = selected.detach()
        intermediate, ref_points, dec_loss = self.decoder(
            tgt, refpoint_undetached.detach(), memory, mask_flat, spatial_shapes, valid_ratios,
            text_dict["encoded_text"], text_dict["text_token_mask"], generator)
        out = {
            "hidden_states": intermediate,  # list of [B, Q, E]
            "references": ref_points,  # list of [B, Q, 4] sigmoided
            "memory_text": text_dict["encoded_text"],
            "topk_idx": topk_idx,  # [B, Q] memory positions chosen as queries
            "adapter_loss": enc_loss + dec_loss,
        }
        if train:
            # two-stage heads' inputs: the selected encoder outputs [B, Q, E]
            # and their boxes [B, Q, 4], sigmoided
            out["hs_enc"] = selected
            out["ref_enc"] = torch.sigmoid(refpoint_undetached)
        return out
