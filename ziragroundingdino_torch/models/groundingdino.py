"""GroundingDINO with ZiRa (`dualzerorepbranchgroundingdino`), the port of
the JAX package's `models/groundingdino.py` for this preset.

Forward I/O as in the JAX package: NHWC pixels (normalized f32, or uint8
normalized on the device) + validity mask [B, H, W] True = valid, and a text
batch (`input_ids`, `text_token_mask`, `position_ids`,
`text_self_attention_masks`) from `text.tokenizer`. `pred_logits` are
token-level [B, Q, max_text_len]; per-category logits come from
`text.masks.recover_to_cls_logits`. `forward(..., train=True)` runs the ZiRa
branches and adds what the criterion needs (`groundingdino.py:407-439` of
the JAX package); a `generator` turns dropout on.

Module and parameter names follow the reference checkpoint, so its
`state_dict` keys are this module's keys: `bert.*`, `feat_map`,
`rep_linear_adapter`, `backbone.0.*` (Swin), `input_proj.{l}.{0,1}`,
`input_proj_conv_adapter.{l}`, `transformer.*`, `bbox_embed.{i}` (one MLP
shared by every decoder layer, also aliased as `transformer.decoder.
bbox_embed`) and the parameter-free `class_embed`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ziragroundingdino_torch.config import GroundingDINOConfig
from ziragroundingdino_torch.models.bert import BertEncoder
from ziragroundingdino_torch.models.heads import ContrastiveEmbed
from ziragroundingdino_torch.models.layers import MLP, Linear
from ziragroundingdino_torch.models.position_encoding import position_embedding_sine_hw
from ziragroundingdino_torch.models.swin import SwinTransformer, interpolate_mask_nearest
from ziragroundingdino_torch.models.transformer import Transformer
from ziragroundingdino_torch.models.zira import Conv2d, RepZeroConv, RepZeroLinear
from ziragroundingdino_torch.ops.box_ops import inverse_sigmoid


class InputProj(nn.Sequential):
    """Per-level 1x1 conv (or 3x3/s2 for an extra level) + GroupNorm(32) in
    f32 (`groundingdino.py:133-150`); keys `input_proj.{l}.0` (conv) and
    `input_proj.{l}.1` (norm). The ZiRa vision branch adds before the norm
    (`groundingdino_dual_zero_rep_branch.py:487-529`)."""

    def __init__(self, cin: int, features: int, kernel_size: int, stride: int,
                 compute_dtype):
        super().__init__(Conv2d(cin, features, kernel_size, stride, compute_dtype=compute_dtype),
                         nn.GroupNorm(32, features, eps=1e-5))
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor, adapter_out: torch.Tensor) -> torch.Tensor:
        y = self[0](x) + adapter_out
        norm = self[1]
        y = nn.functional.group_norm(y.float().permute(0, 3, 1, 2), norm.num_groups,
                                     norm.weight, norm.bias, norm.eps).permute(0, 2, 3, 1)
        return y.to(self.compute_dtype or x.dtype)


def encode_text(bert: BertEncoder, feat_map: Linear, rep_linear_adapter: RepZeroLinear,
                text: Dict[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The text path, BERT -> feat_map + the ZiRa language branch:
    (encoded_text [B, T, E], the branch's ZIL in train mode, else None). The
    ZIL is a mean over valid tokens (`zira.py:35-51` of the JAX package)."""
    bert_out = bert(text["input_ids"], text["text_self_attention_masks"],
                    position_ids=text["position_ids"], generator=generator)
    if train:
        rep_out, loss = rep_linear_adapter.forward_train(bert_out, mask=text["text_token_mask"])
    else:
        rep_out, loss = rep_linear_adapter(bert_out), None
    return feat_map(bert_out) + rep_out, loss


class TextEncoderOnly(nn.Module):
    """The text path of `model` alone, for prompt-memory capture and text
    replay (`groundingdino.py:117-166` of the JAX package; reference
    `groundingdino_dt.py:379-437,786-838`). It holds the model's own `bert`,
    `feat_map` and `rep_linear_adapter`, not copies, so the gradients of a
    replay land on the model's parameters. BERT runs without dropout."""

    def __init__(self, model: "GroundingDINO"):
        super().__init__()
        self.bert = model.bert
        self.feat_map = model.feat_map
        self.rep_linear_adapter = model.rep_linear_adapter

    def forward(self, text: Dict[str, torch.Tensor], train: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(encoded_text [B, T, E], the language branch's ZIL: 0 unless train)."""
        encoded, loss = encode_text(self.bert, self.feat_map, self.rep_linear_adapter, text,
                                    train)
        if loss is None:
            loss = torch.zeros((), dtype=torch.float32, device=encoded.device)
        return encoded, loss


class GroundingDINO(nn.Module):
    def __init__(self, cfg: GroundingDINOConfig):
        super().__init__()
        if cfg.modelname != "dualzerorepbranchgroundingdino":
            raise NotImplementedError(
                f"the port serves dualzerorepbranchgroundingdino, not {cfg.modelname!r}")
        self.cfg = cfg
        cd = cfg.torch_dtype
        e = cfg.hidden_dim
        bert = cfg.bert
        swin = cfg.swin

        self.bert = BertEncoder(bert, cd)
        self.feat_map = Linear(bert.hidden_size, e, compute_dtype=cd, init="xavier")
        self.rep_linear_adapter = RepZeroLinear(
            bert.hidden_size, e, scale_init=cfg.zira_lan_scale,
            zero_value=cfg.zira_zero_init, compute_dtype=cd)
        self.backbone = nn.ModuleList([SwinTransformer(swin, cd)])

        n_backbone = len(swin.out_indices)
        chans = [swin.num_features[i] for i in swin.out_indices]
        projs, adapters = [], []
        for lvl in range(cfg.num_feature_levels):
            if lvl < n_backbone:
                cin, ks, stride = chans[lvl], 1, 1
            else:
                cin, ks, stride = (chans[-1] if lvl == n_backbone else e), 3, 2
            projs.append(InputProj(cin, e, ks, stride, cd))
            adapters.append(RepZeroConv(cin, e, ks, stride, scale_init=cfg.zira_vis_scale,
                                        zero_value=cfg.zira_zero_init, compute_dtype=cd))
        self.input_proj = nn.ModuleList(projs)
        self.input_proj_conv_adapter = nn.ModuleList(adapters)

        self.transformer = Transformer(cfg, cd)
        box_head = MLP(e, e, 4, 3, zero_init_last=True, compute_dtype=torch.float32)
        self.bbox_embed = nn.ModuleList([box_head] * cfg.dec_layers)
        self.transformer.decoder.bbox_embed = self.bbox_embed
        self.class_embed = nn.ModuleList(
            [ContrastiveEmbed(cfg.max_text_len)] * cfg.dec_layers)

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
        `adapter_losses` (the ZILs). `generator` (on the input's device)
        draws dropout and stochastic depth; None means none. Where
        `prompt_replace_mask` is True, the encoded text takes
        `prompt_replace_values` (`train.incremental.build_prompt_injection`)."""
        cfg = self.cfg
        cd = cfg.torch_dtype
        if pixels.dtype == torch.uint8:
            mean = torch.tensor(cfg.pixel_mean, dtype=torch.float32, device=pixels.device)
            std = torch.tensor(cfg.pixel_std, dtype=torch.float32, device=pixels.device)
            pixels = ((pixels.float() - mean) / std).masked_fill(~mask[..., None], 0.0)

        # ---- text path
        encoded_text, loss_linear = encode_text(self.bert, self.feat_map,
                                                self.rep_linear_adapter, text, train, generator)
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
        feats = self.backbone[0](pixels, mask, generator)
        srcs, masks_lvl, poss = [], [], []
        loss_conv = torch.zeros((), dtype=torch.float32, device=pixels.device)
        for lvl in range(cfg.num_feature_levels):
            if lvl < len(feats):
                src_in, m_lvl = feats[lvl]
            else:
                src_in = feats[-1][0] if lvl == len(feats) else srcs[-1]
                m_lvl = None
            adapter = self.input_proj_conv_adapter[lvl]
            if train:
                extra, zil = adapter.forward_train(src_in)
                loss_conv = loss_conv + zil  # summed over levels (`groundingdino.py:305-306`)
            else:
                extra = adapter(src_in)
            src = self.input_proj[lvl](src_in, extra)
            if m_lvl is None:
                m_lvl = interpolate_mask_nearest(mask, src.shape[1], src.shape[2])
            srcs.append(src)
            masks_lvl.append(m_lvl)
            poss.append(position_embedding_sine_hw(
                m_lvl, num_pos_feats=cfg.hidden_dim // 2,
                temperature_h=cfg.pe_temperature_h, temperature_w=cfg.pe_temperature_w,
            ).to(cd))

        class_embed = self.class_embed[0]
        tr = self.transformer(srcs, masks_lvl, poss, text_dict, class_embed, generator, train)
        text_dict = dict(text_dict, encoded_text=tr["memory_text"])

        # anchor-update box outputs (`groundingdino.py:369-376`): layer i
        # refines the references it was given, refs[i]
        hs, refs = tr["hidden_states"], tr["references"]
        layers = range(len(hs)) if train else (len(hs) - 1,)
        boxes = [torch.sigmoid(self.bbox_embed[i](hs[i].float()) + inverse_sigmoid(refs[i]))
                 for i in layers]
        logits = [class_embed(hs[i], text_dict) for i in layers]
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
            out["interm_outputs"] = {"pred_logits": class_embed(tr["hs_enc"], text_dict),
                                     "pred_boxes": tr["ref_enc"]}
        out["adapter_losses"] = {"loss_linear_adapter": loss_linear,
                                 "loss_conv_adapter": loss_conv}
        return out
