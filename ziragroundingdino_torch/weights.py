"""Weight bridge: a parameter tree of the JAX package -> a `state_dict`
of the port, with the reference checkpoint's key names.

`jax_params_to_state_dict` is the inverse of the rule table that the JAX
package uses to read reference checkpoints (`_RULES` in
the JAX package's `utils/torch_convert.py`). The table is kept here as
the port's own copy, in the same orientation (torch key pattern, JAX path
template, layout), and inverted mechanically: the JAX path template
becomes a pattern and the torch pattern a template. Layouts:
  * Linear kernel [in, out]         -> weight [out, in]      (transpose)
  * Conv kernel HWIO                -> weight OIHW
  * LayerNorm/GroupNorm scale/bias  -> weight/bias
  * ResNet FrozenBatchNorm scale / bias / mean / var
                                    -> weight / bias / running_mean / running_var
  * learned positions pos_row_embed / pos_col_embed
                                    -> backbone.1.row_embed / col_embed.weight
  * in_proj_kernel [E, 3E]          -> in_proj_weight [3E, E]
  * ZiRa branch_*/freeze_*          -> weight, bias / freeze_linear|freeze_conv.*
  * RepZeroLoRA down/up_kernel      -> down.weight / up.weight
  * RepZeroConvGN freeze_gn_*       -> freeze_gn.weight / .bias
  * ZeroConvBN branch_* / bn_*      -> branch.conv.* / branch.bn.weight|bias,
    and its `batch_stats` bn_mean / bn_var -> branch.bn.running_mean / _var
  * MoE fc1/fc2 kernels [E, in, out], biases [E, out]
                                    -> experts.{e}.fc1|fc2.weight / .bias,
    one per expert, and the reference's constant `mean` (0) / `std` (1)
    buffers beside them
The box head shared by every decoder layer is one JAX entry
(`bbox_embed`), and so is the class head's `cls_linear` (linear probing);
the state_dict repeats each under `bbox_embed.{i}` / `class_embed.{i}` and
`transformer.decoder.bbox_embed.{i}` / `.class_embed.{i}` for each decoder
layer, as the reference's does.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

# layouts of the JAX leaf relative to the torch tensor
_ID, _LIN, _CONV = "id", "linear", "conv"

_RULES: List[Tuple[str, str, str]] = []


def _rule(pat: str, dst: str, layout: str = _ID) -> None:
    _RULES.append((pat, dst, layout))


def _ln_rules(src: str, dst: str) -> None:
    _rule(src + r"\.weight$", dst + "/scale")
    _rule(src + r"\.bias$", dst + "/bias")


def _lin_rules(src: str, dst: str) -> None:
    _rule(src + r"\.weight$", dst + "/kernel", _LIN)
    _rule(src + r"\.bias$", dst + "/bias")


def _mha_rules(src: str, dst: str) -> None:
    _rule(src + r"\.in_proj_weight$", dst + "/in_proj_kernel", _LIN)
    _rule(src + r"\.in_proj_bias$", dst + "/in_proj_bias")
    _lin_rules(src + r"\.out_proj", dst + "/out_proj")


# ---- backbone (swin)
_rule(r"backbone\.0\.patch_embed\.proj\.weight$", "backbone/patch_embed_proj/kernel", _CONV)
_rule(r"backbone\.0\.patch_embed\.proj\.bias$", "backbone/patch_embed_proj/bias")
_ln_rules(r"backbone\.0\.patch_embed\.norm", "backbone/patch_embed_norm")
_ln_rules(r"backbone\.0\.layers\.(\d+)\.blocks\.(\d+)\.norm1",
          r"backbone/layers_\1_blocks_\2/norm1")
_ln_rules(r"backbone\.0\.layers\.(\d+)\.blocks\.(\d+)\.norm2",
          r"backbone/layers_\1_blocks_\2/norm2")
_rule(r"backbone\.0\.layers\.(\d+)\.blocks\.(\d+)\.attn\.relative_position_bias_table$",
      r"backbone/layers_\1_blocks_\2/attn/relative_position_bias_table")
_lin_rules(r"backbone\.0\.layers\.(\d+)\.blocks\.(\d+)\.attn\.qkv",
           r"backbone/layers_\1_blocks_\2/attn/qkv")
_lin_rules(r"backbone\.0\.layers\.(\d+)\.blocks\.(\d+)\.attn\.proj",
           r"backbone/layers_\1_blocks_\2/attn/proj")
_lin_rules(r"backbone\.0\.layers\.(\d+)\.blocks\.(\d+)\.mlp\.fc1",
           r"backbone/layers_\1_blocks_\2/mlp_fc1")
_lin_rules(r"backbone\.0\.layers\.(\d+)\.blocks\.(\d+)\.mlp\.fc2",
           r"backbone/layers_\1_blocks_\2/mlp_fc2")
_ln_rules(r"backbone\.0\.layers\.(\d+)\.downsample\.norm", r"backbone/layers_\1_downsample/norm")
_rule(r"backbone\.0\.layers\.(\d+)\.downsample\.reduction\.weight$",
      r"backbone/layers_\1_downsample/reduction/kernel", _LIN)
_ln_rules(r"backbone\.0\.norm(\d+)", r"backbone/norm\1")

# ---- backbone (resnet; torchvision's names under the reference's
# IntermediateLayerGetter, `backbone.0.body`). The JAX package's own
# reference-checkpoint table has no ResNet rules: these are the port's.


def _frozen_bn_rules(src: str, dst: str) -> None:
    for t, j in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                 ("running_var", "var")):
        _rule(src + rf"\.{t}$", f"{dst}/{j}")


_rule(r"backbone\.0\.body\.conv1\.weight$", "backbone/conv1/kernel", _CONV)
_frozen_bn_rules(r"backbone\.0\.body\.bn1", "backbone/bn1")
for _i in (1, 2, 3):
    _rule(rf"backbone\.0\.body\.layer(\d+)\.(\d+)\.conv{_i}\.weight$",
          rf"backbone/layer\1_\2/conv{_i}/kernel", _CONV)
    _frozen_bn_rules(rf"backbone\.0\.body\.layer(\d+)\.(\d+)\.bn{_i}",
                     rf"backbone/layer\1_\2/bn{_i}")
_rule(r"backbone\.0\.body\.layer(\d+)\.(\d+)\.downsample\.0\.weight$",
      r"backbone/layer\1_\2/downsample_conv/kernel", _CONV)
_frozen_bn_rules(r"backbone\.0\.body\.layer(\d+)\.(\d+)\.downsample\.1",
                 r"backbone/layer\1_\2/downsample_bn")

# ---- learned position tables (`torch_convert.py:120-123` of the JAX package)
_rule(r"backbone\.1\.row_embed\.weight$", "pos_row_embed")
_rule(r"backbone\.1\.col_embed\.weight$", "pos_col_embed")

# ---- bert
_rule(r"bert\.embeddings\.word_embeddings\.weight$", "bert/word_embeddings")
_rule(r"bert\.embeddings\.position_embeddings\.weight$", "bert/position_embeddings")
_rule(r"bert\.embeddings\.token_type_embeddings\.weight$", "bert/token_type_embeddings")
_ln_rules(r"bert\.embeddings\.LayerNorm", "bert/embeddings_norm")
for _src, _dst in (
    (r"attention\.self\.query", "attention_self/query"),
    (r"attention\.self\.key", "attention_self/key"),
    (r"attention\.self\.value", "attention_self/value"),
    (r"attention\.output\.dense", "attention_output_dense"),
    (r"intermediate\.dense", "intermediate_dense"),
    (r"output\.dense", "output_dense"),
):
    _lin_rules(r"bert\.encoder\.layer\.(\d+)\." + _src, r"bert/layer_\1/" + _dst)
_ln_rules(r"bert\.encoder\.layer\.(\d+)\.attention\.output\.LayerNorm",
          r"bert/layer_\1/attention_output_norm")
_ln_rules(r"bert\.encoder\.layer\.(\d+)\.output\.LayerNorm", r"bert/layer_\1/output_norm")

# ---- text/input projections
_lin_rules(r"feat_map", "feat_map")
_rule(r"input_proj\.(\d+)\.0\.weight$", r"input_proj_\1/conv/kernel", _CONV)
_rule(r"input_proj\.(\d+)\.0\.bias$", r"input_proj_\1/conv/bias")
_ln_rules(r"input_proj\.(\d+)\.1", r"input_proj_\1/norm")

# ---- ZiRa rep branches (the language branch of the dual and the
# multilayer variant, and RepZeroLoRA's bias-free factors)
for _ln in ("rep_linear_adapter", "rep_language_adapter"):
    _rule(rf"{_ln}\.weight$", f"{_ln}/branch_kernel", _LIN)
    _rule(rf"{_ln}\.bias$", f"{_ln}/branch_bias")
    _rule(rf"{_ln}\.scaling$", f"{_ln}/scaling")
    _rule(rf"{_ln}\.freeze_linear\.weight$", f"{_ln}/freeze_kernel", _LIN)
    _rule(rf"{_ln}\.freeze_linear\.bias$", f"{_ln}/freeze_bias")
    _rule(rf"{_ln}\.down\.weight$", f"{_ln}/down_kernel", _LIN)
    _rule(rf"{_ln}\.up\.weight$", f"{_ln}/up_kernel", _LIN)
_rule(r"input_proj_conv_adapter\.(\d+)\.freeze_gn\.weight$",
      r"input_proj_conv_adapter_\1/freeze_gn_scale")
_rule(r"input_proj_conv_adapter\.(\d+)\.freeze_gn\.bias$",
      r"input_proj_conv_adapter_\1/freeze_gn_bias")
_rule(r"input_proj_conv_adapter\.(\d+)\.branch\.bn\.weight$",
      r"input_proj_conv_adapter_\1/bn_scale")
_rule(r"input_proj_conv_adapter\.(\d+)\.branch\.bn\.bias$",
      r"input_proj_conv_adapter_\1/bn_bias")
# the BN statistics live in JAX's `batch_stats` collection
_rule(r"input_proj_conv_adapter\.(\d+)\.branch\.bn\.running_mean$",
      r"<stats>input_proj_conv_adapter_\1/bn_mean")
_rule(r"input_proj_conv_adapter\.(\d+)\.branch\.bn\.running_var$",
      r"<stats>input_proj_conv_adapter_\1/bn_var")
_rule(r"input_proj_conv_adapter\.(\d+)\.weight$",
      r"input_proj_conv_adapter_\1/branch_kernel", _CONV)
_rule(r"input_proj_conv_adapter\.(\d+)\.bias$", r"input_proj_conv_adapter_\1/branch_bias")
_rule(r"input_proj_conv_adapter\.(\d+)\.scaling$", r"input_proj_conv_adapter_\1/scaling")
_rule(r"input_proj_conv_adapter\.(\d+)\.freeze_conv\.weight$",
      r"input_proj_conv_adapter_\1/freeze_kernel", _CONV)
_rule(r"input_proj_conv_adapter\.(\d+)\.freeze_conv\.bias$",
      r"input_proj_conv_adapter_\1/freeze_bias")
# ZeroConvBN names its branch conv `branch.conv`, where the other vision
# branches hold it as the module's own weight and bias: the same JAX leaf
# (`branch_kernel`) maps to either, by whether the module has a `bn_scale`
# (`_convbn_names`)
_CONVBN = re.compile(r"(input_proj_conv_adapter\.\d+)\.(weight|bias)$")

# ---- the CET language adapter (the dt model; `torch_convert.py:170-174` of
# the JAX package): Adapter, LinearAdapter, or TransformerAdapter, whose
# names follow the MHA / LN / Linear rules
for _n in ("adapter_down", "adapter_up", "linear", "linear1", "linear2", "project_out"):
    _lin_rules(rf"cet_adapter\.{_n}", f"cet_adapter/{_n}")
_rule(r"cet_adapter\.gate\.weight$", "cet_adapter/gate/gate")
_mha_rules(r"cet_adapter\.self_attn", "cet_adapter/self_attn")
for _n in ("norm1", "norm2"):
    _ln_rules(rf"cet_adapter\.{_n}", f"cet_adapter/{_n}")

# ---- CAT: the conditional prompt's MoE gate (its experts: `_MOE_EXPERT`)
# and the in-layer adapters (`transformer_for_adapter.py:850,969`)
for _g in ("w_gate", "w_noise"):
    _rule(rf"prompt_adapter\.adapter_moe\.{_g}$", f"prompt_adapter/adapter_moe/{_g}")
for _side in ("encoder", "decoder"):
    for _n in ("adapter_down", "adapter_up"):
        _lin_rules(rf"transformer\.{_side}\.layers\.(\d+)\.adapter\.{_n}",
                   rf"transformer/{_side}/layers_\1/adapter/{_n}")
    _rule(rf"transformer\.{_side}\.layers\.(\d+)\.adapter\.gate\.weight$",
          rf"transformer/{_side}/layers_\1/adapter/gate/gate")
# the JAX MoE stacks its experts: one leaf, a torch tensor per expert
_MOE_EXPERT = re.compile(r"(.*)/adapter_moe/(fc[12])_(kernel|bias)$")

# ---- transformer top level
_rule(r"transformer\.level_embed$", "transformer/level_embed")
_rule(r"transformer\.tgt_embed\.weight$", "transformer/tgt_embed")
_lin_rules(r"transformer\.enc_output", "transformer/enc_output")
_ln_rules(r"transformer\.enc_output_norm", "transformer/enc_output_norm")
for _j in range(3):
    _lin_rules(rf"transformer\.enc_out_bbox_embed\.layers\.{_j}",
               rf"enc_out_bbox_embed/layers_{_j}")
_lin_rules(r"transformer\.enc_out_class_embed\.cls_linear", "enc_out_class_embed/cls_linear")

# ---- encoder
for _side, _attn in (("encoder", "self_attn"), ("decoder", "cross_attn")):
    for _proj in ("sampling_offsets", "attention_weights", "value_proj", "output_proj"):
        _lin_rules(rf"transformer\.{_side}\.layers\.(\d+)\.{_attn}\.{_proj}",
                   rf"transformer/{_side}/layers_\1/{_attn}/{_proj}")
for _n in ("norm1", "norm2"):
    _ln_rules(rf"transformer\.encoder\.layers\.(\d+)\.{_n}", rf"transformer/encoder/layers_\1/{_n}")
for _n in ("linear1", "linear2"):
    _lin_rules(rf"transformer\.encoder\.layers\.(\d+)\.{_n}",
               rf"transformer/encoder/layers_\1/{_n}")
_mha_rules(r"transformer\.encoder\.text_layers\.(\d+)\.self_attn",
           r"transformer/encoder/text_layers_\1/self_attn")
for _n in ("norm1", "norm2"):
    _ln_rules(rf"transformer\.encoder\.text_layers\.(\d+)\.{_n}",
              rf"transformer/encoder/text_layers_\1/{_n}")
for _n in ("linear1", "linear2"):
    _lin_rules(rf"transformer\.encoder\.text_layers\.(\d+)\.{_n}",
               rf"transformer/encoder/text_layers_\1/{_n}")
for _n in ("layer_norm_v", "layer_norm_l"):
    _ln_rules(rf"transformer\.encoder\.fusion_layers\.(\d+)\.{_n}",
              rf"transformer/encoder/fusion_layers_\1/{_n}")
for _proj in ("v_proj", "l_proj", "values_v_proj", "values_l_proj", "out_v_proj", "out_l_proj"):
    _lin_rules(rf"transformer\.encoder\.fusion_layers\.(\d+)\.attn\.{_proj}",
               rf"transformer/encoder/fusion_layers_\1/attn/{_proj}")
for _g in ("gamma_v", "gamma_l"):
    _rule(rf"transformer\.encoder\.fusion_layers\.(\d+)\.{_g}$",
          rf"transformer/encoder/fusion_layers_\1/{_g}")

# ---- decoder
_mha_rules(r"transformer\.decoder\.layers\.(\d+)\.self_attn",
           r"transformer/decoder/layers_\1/self_attn")
_mha_rules(r"transformer\.decoder\.layers\.(\d+)\.ca_text",
           r"transformer/decoder/layers_\1/ca_text")
for _n in ("catext_norm", "norm1", "norm2", "norm3"):
    _ln_rules(rf"transformer\.decoder\.layers\.(\d+)\.{_n}", rf"transformer/decoder/layers_\1/{_n}")
for _n in ("linear1", "linear2"):
    _lin_rules(rf"transformer\.decoder\.layers\.(\d+)\.{_n}",
               rf"transformer/decoder/layers_\1/{_n}")
_ln_rules(r"transformer\.decoder\.norm", "transformer/decoder/norm")
for _j in range(2):
    _lin_rules(rf"transformer\.decoder\.ref_point_head\.layers\.{_j}",
               rf"transformer/decoder/ref_point_head/layers_{_j}")

# ---- heads: the canonical copies of the shared box and class heads
for _j in range(3):
    _lin_rules(rf"bbox_embed\.0\.layers\.{_j}", rf"bbox_embed/layers_{_j}")
_lin_rules(r"class_embed\.0\.cls_linear", "class_embed/cls_linear")


def _invert(pat: str, dst: str) -> Tuple["re.Pattern", str]:
    """(JAX path pattern, torch key template) of one rule."""
    path_pat = re.escape(dst)
    for i in (1, 2):
        path_pat = path_pat.replace(re.escape(f"\\{i}"), r"(\d+)")
    key = pat.rstrip("$").replace(r"\.", ".")
    i = 0
    while r"(\d+)" in key:
        i += 1
        key = key.replace(r"(\d+)", f"\\{i}", 1)
    return re.compile(path_pat + "$"), key


_INVERSE = [(*_invert(pat, dst), layout) for pat, dst, layout in _RULES]


def _to_torch_layout(a: np.ndarray, layout: str) -> np.ndarray:
    if layout == _LIN:
        return a.T
    if layout == _CONV:
        return a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    return a


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _convbn_names(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The branch conv of every ZeroConvBN (a module with `branch.bn.weight`)
    under `branch.conv.*`; every other key as it is."""
    out = {}
    for key, v in sd.items():
        m = _CONVBN.match(key)
        if m is not None and f"{m.group(1)}.branch.bn.weight" in sd:
            key = f"{m.group(1)}.branch.conv.{m.group(2)}"
        out[key] = v
    return out


def jax_params_to_state_dict(params: Mapping, batch_stats: Optional[Mapping] = None
                             ) -> Dict[str, torch.Tensor]:
    """Flax params (nested dict of arrays, the "params" collection or a dict
    holding it, and with it its "batch_stats" collection, or those passed as
    `batch_stats`) -> state_dict with the reference's keys, float32 tensors.
    Raises on a leaf that no rule maps."""
    if "params" in params and isinstance(params["params"], Mapping):
        if batch_stats is None:
            batch_stats = params.get("batch_stats")
        params = params["params"]
    leaves = dict(_flatten(params))
    leaves.update({"<stats>" + k: v for k, v in _flatten(batch_stats or {}).items()})
    sd: Dict[str, torch.Tensor] = {}
    unmapped = []
    for path, leaf in leaves.items():
        m = _MOE_EXPERT.match(path)
        if m is not None:
            prefix = m.group(1).replace("/", ".") + ".adapter_moe"
            part = "weight" if m.group(3) == "kernel" else "bias"
            for e, a in enumerate(leaf):
                sd[f"{prefix}.experts.{e}.{m.group(2)}.{part}"] = torch.from_numpy(
                    np.array(a.T if part == "weight" else a, dtype=np.float32))
            sd[f"{prefix}.mean"] = torch.zeros(1)
            sd[f"{prefix}.std"] = torch.ones(1)
            continue
        for pattern, template, layout in _INVERSE:
            m = pattern.match(path)
            if m is not None:
                key = m.expand(template)
                sd[key] = torch.from_numpy(
                    np.array(_to_torch_layout(leaf, layout), dtype=np.float32))
                break
        else:
            unmapped.append(path)
    if unmapped:
        raise KeyError(f"no rule maps these JAX parameters: {unmapped[:10]}")
    sd = _convbn_names(sd)
    dec_layers = len({k.split(".")[3] for k in sd if k.startswith("transformer.decoder.layers.")})
    for head in ("bbox_embed", "class_embed"):
        for key in [k for k in sd if k.startswith(f"{head}.0.")]:
            rest = key[len(f"{head}.0."):]
            for i in range(dec_layers):
                sd[f"{head}.{i}.{rest}"] = sd[key]
                sd[f"transformer.decoder.{head}.{i}.{rest}"] = sd[key]
    return sd
