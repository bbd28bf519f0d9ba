"""GroundingDINO with ZiRa (`dualzerorepbranchgroundingdino`), the port of the
serving path of the JAX package's `models/groundingdino.py`.

Forward I/O as in the JAX package: NHWC pixels (normalized f32, or uint8
normalized on the device) + validity mask [B, H, W] True = valid, and a text
batch (`input_ids`, `text_token_mask`, `position_ids`,
`text_self_attention_masks`) from `text.tokenizer`. `pred_logits` are
token-level [B, Q, max_text_len]; per-category logits come from
`text.masks.recover_to_cls_logits`.

Module and parameter names follow the reference checkpoint, so its
`state_dict` keys are this module's keys: `bert.*`, `feat_map`,
`rep_linear_adapter`, `backbone.0.*` (Swin), `input_proj.{l}.{0,1}`,
`input_proj_conv_adapter.{l}`, `transformer.*`, `bbox_embed.{i}` (one MLP
shared by every decoder layer, also aliased as `transformer.decoder.
bbox_embed`) and the parameter-free `class_embed`.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from ziragroundingdino_torch.config import GroundingDINOConfig
from ziragroundingdino_torch.models.bert import BertEncoder
from ziragroundingdino_torch.models.heads import ContrastiveEmbed
from ziragroundingdino_torch.models.layers import MLP, Linear, inverse_sigmoid
from ziragroundingdino_torch.models.position_encoding import position_embedding_sine_hw
from ziragroundingdino_torch.models.swin import SwinTransformer, interpolate_mask_nearest
from ziragroundingdino_torch.models.transformer import Transformer
from ziragroundingdino_torch.models.zira import Conv2d, RepZeroConv, RepZeroLinear


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
    ) -> Dict[str, Any]:
        cfg = self.cfg
        cd = cfg.torch_dtype
        if pixels.dtype == torch.uint8:
            mean = torch.tensor(cfg.pixel_mean, dtype=torch.float32, device=pixels.device)
            std = torch.tensor(cfg.pixel_std, dtype=torch.float32, device=pixels.device)
            pixels = ((pixels.float() - mean) / std).masked_fill(~mask[..., None], 0.0)

        # ---- text path
        bert_out = self.bert(text["input_ids"], text["text_self_attention_masks"],
                             position_ids=text["position_ids"])
        encoded_text = self.feat_map(bert_out) + self.rep_linear_adapter(bert_out)
        text_dict = {
            "encoded_text": encoded_text,
            "text_token_mask": text["text_token_mask"],
            "position_ids": text["position_ids"],
            "text_self_attention_masks": text["text_self_attention_masks"],
        }

        # ---- image path
        feats = self.backbone[0](pixels, mask)
        srcs, masks_lvl, poss = [], [], []
        for lvl in range(cfg.num_feature_levels):
            if lvl < len(feats):
                src_in, m_lvl = feats[lvl]
            else:
                src_in = feats[-1][0] if lvl == len(feats) else srcs[-1]
                m_lvl = None
            src = self.input_proj[lvl](src_in, self.input_proj_conv_adapter[lvl](src_in))
            if m_lvl is None:
                m_lvl = interpolate_mask_nearest(mask, src.shape[1], src.shape[2])
            srcs.append(src)
            masks_lvl.append(m_lvl)
            poss.append(position_embedding_sine_hw(
                m_lvl, num_pos_feats=cfg.hidden_dim // 2,
                temperature_h=cfg.pe_temperature_h, temperature_w=cfg.pe_temperature_w,
            ).to(cd))

        class_embed = self.class_embed[0]
        tr = self.transformer(srcs, masks_lvl, poss, text_dict, class_embed)
        text_dict = dict(text_dict, encoded_text=tr["memory_text"])

        # anchor-update box output of the last layer (`groundingdino.py:369-376`)
        hs = tr["hidden_states"][-1]
        delta = self.bbox_embed[-1](hs.float())
        return {
            "pred_logits": class_embed(hs, text_dict),  # [B, Q, max_text_len] f32
            "pred_boxes": torch.sigmoid(delta + inverse_sigmoid(tr["references"][-2])),
            "encoded_text": text_dict["encoded_text"],
            "topk_idx": tr["topk_idx"],
        }
