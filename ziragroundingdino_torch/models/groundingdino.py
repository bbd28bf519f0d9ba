"""GroundingDINO, its ZiRa family and the PET baselines, the port of the
JAX package's `models/groundingdino.py` for every preset of
`config.MODEL_PRESETS`:
  * `groundingdino`, the vanilla open-set detector (no branch at all);
  * `dualzerorepbranchgroundingdino`, ZiRa: a language branch on the BERT
    output (`rep_linear_adapter`, a RepZeroLinear or with
    `zira_lan_adapter="lora"` a RepZeroLoRA) and a RepZeroConv per input
    projection (`input_proj_conv_adapter.{l}`), added before its GroupNorm;
  * `dualzerorepmultilayerbranchgroundingdino`: `rep_language_adapter`
    (scaling 1.0, L1 ZIL) and RepZeroConvGN branches added after the whole
    projection;
  * `repgroundingdino` / `repconvbngroundingdino`: vision branches only,
    RepZeroConv before the norm / ZeroConvBN after the projection;
  * `dtgroundingdino` and the PET baselines on it (`finetune`,
    `linearprobe`, `prompttune`, `berttune`, `projecttune`): with `use_cet`
    the CET language adapter `cet_adapter` (any model without a ZiRa
    language branch builds it), with `use_cls_linear` a `cls_linear` in
    the class heads and a separate two-stage head; the other switches pick
    the trainable parameters only (`train/optim.py`);
  * `catgroundingdino`: an in-layer `adapter` in every encoder and decoder
    layer (`use_adapter`) and, with `use_prompt`, the conditional prompt
    `prompt_adapter` (an MoE adapter over the pooled deepest level, added
    to the encoded text).

Forward I/O as in the JAX package: NHWC pixels (normalized f32, or uint8
normalized on the device) + validity mask [B, H, W] True = valid, and a text
batch (`input_ids`, `text_token_mask`, `position_ids`,
`text_self_attention_masks`) from `text.tokenizer`. `pred_logits` are
token-level [B, Q, max_text_len]; per-category logits come from
`text.masks.recover_to_cls_logits`. `forward(..., train=True)` runs the ZiRa
branches and adds what the criterion needs (`groundingdino.py:407-439` of
the JAX package); a `generator` turns dropout on.

The backbone is `cfg.backbone`: a Swin variant of `config.SWIN_VARIANTS`
(Swin-T by default; GroundingDINO-B is `swin_B_384_22k`) or `resnet50` /
`resnet101` (`models/resnet.py`); the input projections take its channels.
Positions are sine, or with `position_embedding="learned"` (or "v3") the
learned tables of `backbone.1`. Without `sub_sentence_present` BERT sees
the [B, T] token mask and default positions instead of the per-phrase
block mask and position ids.

Module and parameter names follow the reference checkpoint, so its
`state_dict` keys are this module's keys: `bert.*`, `feat_map`, the
language branch, `backbone.0.*` (Swin, or `backbone.0.body.*` for
ResNet), `backbone.1.*` (learned positions), `input_proj.{l}.{0,1}`,
`input_proj_conv_adapter.{l}`, `transformer.*`, `bbox_embed.{i}` (one MLP
shared by every decoder layer, also aliased as `transformer.decoder.
bbox_embed`) and `class_embed.{i}` (one head, parameter-free unless
`use_cls_linear`, aliased as `transformer.decoder.class_embed`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ziragroundingdino_torch.config import RESNET_DEPTHS, SWIN_VARIANTS, GroundingDINOConfig
from ziragroundingdino_torch.device import device_constant
from ziragroundingdino_torch.models.adapters import MoeAdapter, cet_adapter
from ziragroundingdino_torch.models.bert import BertEncoder
from ziragroundingdino_torch.models.heads import ContrastiveEmbed
from ziragroundingdino_torch.models.layers import MLP, Linear
from ziragroundingdino_torch.models.position_encoding import (
    PositionEmbeddingLearned,
    position_embedding_sine_hw,
)
from ziragroundingdino_torch.models.resnet import ResNetBackbone
from ziragroundingdino_torch.models.swin import SwinTransformer, interpolate_mask_nearest
from ziragroundingdino_torch.models.transformer import Transformer
from ziragroundingdino_torch.models.zira import (
    Conv2d,
    RepZeroConv,
    RepZeroConvGN,
    RepZeroLinear,
    RepZeroLoRA,
    ZeroConvBN,
)
from ziragroundingdino_torch.ops.box_ops import inverse_sigmoid
from ziragroundingdino_torch.utils import profiling

# the reparameterizable family (`groundingdino.py:48-53` of the JAX package)
ZIRA_MODELNAMES = (
    "dualzerorepbranchgroundingdino",
    "dualzerorepmultilayerbranchgroundingdino",
    "repgroundingdino",
    "repconvbngroundingdino",
)
# every model name of the JAX package (`config.py:236-280` there)
MODELNAMES = ("groundingdino", "dtgroundingdino", "catgroundingdino") + ZIRA_MODELNAMES
# variants whose vision branch adds after the whole input projection
# (`groundingdino_repconvbn.py:613-614`, `multilayer_branch.py:575-576`);
# the others add before its GroupNorm (`dual_zero_rep_branch.py:487-529`)
POST_NORM_ADAPTER = ("repconvbngroundingdino", "dualzerorepmultilayerbranchgroundingdino")
# `position_embedding` values: the reference's names and their aliases
SINE_POSITIONS, LEARNED_POSITIONS = ("sine", "v2"), ("learned", "v3")


def _backbone(cfg: GroundingDINOConfig, cd) -> nn.Module:
    """`backbone.0`: the ResNet or Swin variant that `cfg.backbone` names
    (`groundingdino.py:258-268` of the JAX package)."""
    if cfg.backbone in RESNET_DEPTHS:
        return ResNetBackbone(RESNET_DEPTHS[cfg.backbone], cfg.return_interm_indices, cd)
    if cfg.backbone in SWIN_VARIANTS or cfg.swin_config is not None:
        return SwinTransformer(cfg.swin, cd)
    raise ValueError(f"unknown backbone {cfg.backbone!r}: not one of "
                     f"{sorted(SWIN_VARIANTS) + sorted(RESNET_DEPTHS)}")


def _language_adapter(cfg: GroundingDINOConfig, cd) -> Tuple[Optional[str], Optional[nn.Module]]:
    """(name, module) of the language branch, (None, None) without
    `use_cet`: the ZiRa branch of the dual and multilayer variants
    (`groundingdino.py:55-77` of the JAX package), the CET adapter
    `cet_adapter` on any other model (`:143-164, :218-238`; for the rep
    variants `groundingdino_repconvbn.py:253-270`)."""
    if not cfg.use_cet:
        return None, None
    bert_dim, e = cfg.bert.hidden_size, cfg.hidden_dim
    if cfg.modelname == "dualzerorepbranchgroundingdino":
        if cfg.zira_lan_adapter == "lora":
            return "rep_linear_adapter", RepZeroLoRA(
                bert_dim, e, down_dim=cfg.zira_lora_down_dim, scale_init=cfg.zira_lan_scale,
                zero_value=cfg.zira_zero_init, compute_dtype=cd)
        return "rep_linear_adapter", RepZeroLinear(
            bert_dim, e, scale_init=cfg.zira_lan_scale, zero_value=cfg.zira_zero_init,
            compute_dtype=cd)
    if cfg.modelname == "dualzerorepmultilayerbranchgroundingdino":
        # `multilayer_branch.py:322-324`: scaling init 1.0, L1 ZIL
        return "rep_language_adapter", RepZeroLinear(
            bert_dim, e, scale_init=1.0, zero_value=cfg.zira_zero_init, compute_dtype=cd,
            zil="l1")
    return "cet_adapter", cet_adapter(cfg, cd)


def _vision_adapter(cfg: GroundingDINOConfig, cin: int, ks: int, stride: int, cd) -> nn.Module:
    """The ZiRa vision branch of one input projection (`groundingdino.py:
    80-86, :306-322` of the JAX package)."""
    e, zv = cfg.hidden_dim, cfg.zira_zero_init
    if cfg.modelname == "dualzerorepmultilayerbranchgroundingdino":
        return RepZeroConvGN(cin, e, ks, stride, zero_value=zv, compute_dtype=cd)
    if cfg.modelname == "repconvbngroundingdino":
        return ZeroConvBN(cin, e, ks, stride, zero_value=zv, compute_dtype=cd)
    return RepZeroConv(cin, e, ks, stride, scale_init=cfg.zira_vis_scale, zero_value=zv,
                       compute_dtype=cd)


class InputProj(nn.Sequential):
    """Per-level 1x1 conv (or 3x3/s2 for an extra level) + GroupNorm(32) in
    f32 (`groundingdino.py:133-150`); keys `input_proj.{l}.0` (conv) and
    `input_proj.{l}.1` (norm). The dual ZiRa and repconv vision branches add
    before the norm (`groundingdino_dual_zero_rep_branch.py:487-529`)."""

    def __init__(self, cin: int, features: int, kernel_size: int, stride: int,
                 compute_dtype):
        super().__init__(Conv2d(cin, features, kernel_size, stride, compute_dtype=compute_dtype),
                         nn.GroupNorm(32, features, eps=1e-5))
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor, adapter_out: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        y = self[0](x)
        if adapter_out is not None:
            y = y + adapter_out
        norm = self[1]
        y = nn.functional.group_norm(y.float().permute(0, 3, 1, 2), norm.num_groups,
                                     norm.weight, norm.bias, norm.eps).permute(0, 2, 3, 1)
        return y.to(self.compute_dtype or x.dtype)


def encode_text(bert: BertEncoder, feat_map: Linear, lang_adapter: Optional[nn.Module],
                text: Dict[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None, sub_sentence_present: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The text path, BERT -> feat_map + the language branch where the
    model has one: (encoded_text [B, T, E], the branch's f32 loss, 0
    without a branch). A ZiRa branch runs its own branch and gives its ZIL
    (a mean over valid tokens, `zira.py:35-51` of the JAX package) in train
    mode only; the CET adapter runs alike in both modes and gives its
    (self-KD) loss. BERT attends within each phrase at its position ids,
    or without `sub_sentence_present` over every valid token at its place."""
    if sub_sentence_present:
        bert_out = bert(text["input_ids"], text["text_self_attention_masks"],
                        position_ids=text["position_ids"], generator=generator)
    else:
        bert_out = bert(text["input_ids"], text["text_token_mask"], generator=generator)
    encoded = feat_map(bert_out)
    if lang_adapter is None:
        return encoded, torch.zeros((), dtype=torch.float32, device=encoded.device)
    out, loss = lang_adapter.text_branch(bert_out, train, text["text_token_mask"])
    return encoded + out, loss


class TextEncoderOnly(nn.Module):
    """The text path of `model` alone, for prompt-memory capture and text
    replay (`groundingdino.py:117-166` of the JAX package; reference
    `groundingdino_dt.py:379-437,786-838`). It holds the model's own `bert`,
    `feat_map` and language branch (under the model's name for it), not
    copies, so the gradients of a replay land on the model's parameters.
    BERT runs without dropout."""

    def __init__(self, model: "GroundingDINO"):
        super().__init__()
        self.bert = model.bert
        self.feat_map = model.feat_map
        self.sub_sentence_present = model.cfg.sub_sentence_present
        self.lang_adapter_name = model.lang_adapter_name
        if self.lang_adapter_name is not None:
            self.add_module(self.lang_adapter_name, model.lang_adapter)

    @property
    def lang_adapter(self) -> Optional[nn.Module]:
        return None if self.lang_adapter_name is None else getattr(self, self.lang_adapter_name)

    def forward(self, text: Dict[str, torch.Tensor], train: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(encoded_text [B, T, E], the language branch's ZIL: 0 unless train
        and the model has one)."""
        return encode_text(self.bert, self.feat_map, self.lang_adapter, text, train,
                           sub_sentence_present=self.sub_sentence_present)


class GroundingDINO(nn.Module):
    def __init__(self, cfg: GroundingDINOConfig):
        super().__init__()
        if cfg.modelname not in MODELNAMES:
            raise ValueError(f"unknown modelname {cfg.modelname!r}: not one of {MODELNAMES}")
        if cfg.position_embedding not in SINE_POSITIONS + LEARNED_POSITIONS:
            raise ValueError(f"unknown position_embedding {cfg.position_embedding!r}: not one "
                             f"of {SINE_POSITIONS + LEARNED_POSITIONS}")
        self.cfg = cfg
        cd = cfg.torch_dtype
        e = cfg.hidden_dim
        bert = cfg.bert
        is_zira = cfg.modelname in ZIRA_MODELNAMES

        self.bert = BertEncoder(bert, cd)
        self.feat_map = Linear(bert.hidden_size, e, compute_dtype=cd, init="xavier")
        self.lang_adapter_name, lang_adapter = _language_adapter(cfg, cd)
        if lang_adapter is not None:
            self.add_module(self.lang_adapter_name, lang_adapter)
        body = _backbone(cfg, cd)
        self.learned_positions = cfg.position_embedding in LEARNED_POSITIONS
        self.backbone = nn.ModuleList(
            [body, PositionEmbeddingLearned(e // 2)] if self.learned_positions else [body])

        chans = body.out_channels
        n_backbone = len(chans)
        projs, adapters = [], []
        for lvl in range(cfg.num_feature_levels):
            if lvl < n_backbone:
                cin, ks, stride = chans[lvl], 1, 1
            else:
                cin, ks, stride = (chans[-1] if lvl == n_backbone else e), 3, 2
            projs.append(InputProj(cin, e, ks, stride, cd))
            if cfg.use_project_adapter and is_zira:
                adapters.append(_vision_adapter(cfg, cin, ks, stride, cd))
        self.input_proj = nn.ModuleList(projs)
        self.input_proj_conv_adapter = nn.ModuleList(adapters) if adapters else None
        self.post_norm_adapter = cfg.modelname in POST_NORM_ADAPTER

        # CAT's conditional prompt (`groundingdino_conditional_adapter_tuning.py:137-146`)
        self.prompt_adapter = (
            MoeAdapter(e, 64, 1.0, cfg.num_experts, cfg.num_topk_experts, use_self_kd=False,
                       output_dim=e, compute_dtype=cd) if cfg.use_prompt else None)

        self.transformer = Transformer(cfg, cd)
        box_head = MLP(e, e, 4, 3, zero_init_last=True, compute_dtype=torch.float32)
        self.bbox_embed = nn.ModuleList([box_head] * cfg.dec_layers)
        self.transformer.decoder.bbox_embed = self.bbox_embed
        class_head = ContrastiveEmbed(cfg.max_text_len, cfg.use_cls_linear, e, cd)
        self.class_embed = nn.ModuleList([class_head] * cfg.dec_layers)
        self.transformer.decoder.class_embed = self.class_embed

    @property
    def lang_adapter(self) -> Optional[nn.Module]:
        """The language branch (ZiRa or CET), None where the model has none."""
        return None if self.lang_adapter_name is None else getattr(self, self.lang_adapter_name)

    def forward(
        self,
        pixels: torch.Tensor,  # [B, H, W, 3] normalized f32, or uint8
        mask: torch.Tensor,  # [B, H, W] bool True = valid
        text: Dict[str, torch.Tensor],
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        prompt_replace_values: Optional[torch.Tensor] = None,  # [B, T, E]
        prompt_replace_mask: Optional[torch.Tensor] = None,  # [B, T] bool
    ) -> Dict[str, Any]:
        """Detections: `pred_logits` [B, Q, max_text_len] f32, `pred_boxes`
        [B, Q, 4] cxcywh, `encoded_text`, `topk_idx`. With `train`, the ZiRa
        branches run beside the frozen ones, and the output adds
        `aux_outputs` (the first dec_layers - 1 decoder layers, with
        cfg.aux_loss), `interm_outputs` (the two-stage heads) and
        `adapter_losses`: the language branch's (`loss_linear_adapter`) and
        the vision branches' (`loss_conv_adapter`) ZILs, and the in-layer
        adapters' and the conditional prompt's losses (`loss_adapter`).
        `generator` (on the input's device) draws dropout, stochastic depth
        and CAT's noisy MoE gating; None means none. Where
        `prompt_replace_mask` is True, the encoded text takes
        `prompt_replace_values` (`train.incremental.build_prompt_injection`)."""
        cfg = self.cfg
        cd = cfg.torch_dtype
        if pixels.dtype == torch.uint8:
            mean = device_constant(tuple(cfg.pixel_mean), pixels.device)
            std = device_constant(tuple(cfg.pixel_std), pixels.device)
            pixels = ((pixels.float() - mean) / std).masked_fill(~mask[..., None], 0.0)

        # ---- text path
        with profiling.span("model.text"):
            encoded_text, loss_linear = encode_text(self.bert, self.feat_map, self.lang_adapter,
                                                    text, train, generator,
                                                    cfg.sub_sentence_present)
        zero = torch.zeros((), dtype=torch.float32, device=pixels.device)
        if prompt_replace_values is not None and prompt_replace_mask is not None:
            # prompt-memory injection: learned classes' token features
            # replaced by their stored embeddings (`groundingdino_dt.py:521-531`)
            encoded_text = torch.where(prompt_replace_mask[..., None],
                                       prompt_replace_values.to(encoded_text.dtype), encoded_text)
        text_dict = {
            "encoded_text": encoded_text,
            "text_token_mask": text["text_token_mask"],
            "position_ids": text["position_ids"],
            "text_self_attention_masks": text["text_self_attention_masks"],
        }

        # ---- image path
        profiling.mark("backbone")
        with profiling.span("model.backbone"):
            feats = self.backbone[0](pixels, mask, generator)
        srcs, masks_lvl, poss = [], [], []
        loss_conv = zero
        for lvl in range(cfg.num_feature_levels):
            if lvl < len(feats):
                src_in, m_lvl = feats[lvl]
            else:
                src_in = feats[-1][0] if lvl == len(feats) else srcs[-1]
                m_lvl = None
            extra = None
            if self.input_proj_conv_adapter is not None:
                adapter = self.input_proj_conv_adapter[lvl]
                if train:
                    extra, zil = adapter.forward_train(src_in)
                    loss_conv = loss_conv + zil  # summed over levels (`groundingdino.py:305-306`)
                else:
                    extra = adapter(src_in)
            if self.post_norm_adapter and extra is not None:
                src = self.input_proj[lvl](src_in) + extra
            else:
                src = self.input_proj[lvl](src_in, extra)
            if m_lvl is None:
                m_lvl = interpolate_mask_nearest(mask, src.shape[1], src.shape[2])
            srcs.append(src)
            masks_lvl.append(m_lvl)
            if self.learned_positions:
                poss.append(self.backbone[1](m_lvl).to(cd))
            else:
                poss.append(position_embedding_sine_hw(
                    m_lvl, num_pos_feats=cfg.hidden_dim // 2,
                    temperature_h=cfg.pe_temperature_h, temperature_w=cfg.pe_temperature_w,
                ).to(cd))

        # CAT's conditional prompt (`groundingdino_conditional_adapter_tuning.py:
        # 366-378`): the deepest level pooled, padding included, through the
        # MoE adapter (noisy gating where dropout is on), added to the text
        prompt_loss = zero
        if self.prompt_adapter is not None:
            ctx = srcs[-1].float().mean(dim=(1, 2))[:, None, :]
            prompt_out, prompt_loss = self.prompt_adapter(ctx.to(cd), generator)
            # a mean over equal-shaped shards (the loader pins the bucket):
            # DDP's mean of the ranks' is the global batch's
            prompt_loss = prompt_loss + prompt_out.float().abs().mean()
            text_dict = dict(text_dict, encoded_text=text_dict["encoded_text"] + prompt_out)

        class_embed = self.class_embed[0]
        enc_class_embed = self.transformer.enc_out_class_embed
        if enc_class_embed is None:
            enc_class_embed = class_embed
        tr = self.transformer(srcs, masks_lvl, poss, text_dict, enc_class_embed, generator,
                              train)
        text_dict = dict(text_dict, encoded_text=tr["memory_text"])

        # anchor-update box outputs (`groundingdino.py:369-376`): layer i
        # refines the references it was given, refs[i]
        hs, refs = tr["hidden_states"], tr["references"]
        layers = range(len(hs)) if train else (len(hs) - 1,)
        with profiling.span("model.heads"):
            boxes = [torch.sigmoid(self.bbox_embed[i](hs[i].float()) + inverse_sigmoid(refs[i]))
                     for i in layers]
            logits = [class_embed(hs[i], text_dict) for i in layers]
            interm_logits = (enc_class_embed(tr["hs_enc"], text_dict) if train and cfg.aux_loss
                             else None)
        out = {
            "pred_logits": logits[-1],  # [B, Q, max_text_len] f32
            "pred_boxes": boxes[-1],
            "encoded_text": text_dict["encoded_text"],
            "topk_idx": tr["topk_idx"],
        }
        if not train:
            return out
        if cfg.aux_loss:
            out["aux_outputs"] = [{"pred_logits": c, "pred_boxes": b}
                                  for c, b in zip(logits[:-1], boxes[:-1])]
            out["interm_outputs"] = {"pred_logits": interm_logits, "pred_boxes": tr["ref_enc"]}
        out["adapter_losses"] = {
            "loss_linear_adapter": loss_linear,
            "loss_conv_adapter": loss_conv,
            "loss_adapter": tr["adapter_loss"] + prompt_loss}
        return out
