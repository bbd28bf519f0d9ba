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
  * in_proj_kernel [E, 3E]          -> in_proj_weight [3E, E]
  * ZiRa branch_*/freeze_*          -> weight, bias / freeze_linear|freeze_conv.*
The box head shared by every decoder layer is one JAX entry
(`bbox_embed`); the state_dict repeats it under `bbox_embed.{i}` and
`transformer.decoder.bbox_embed.{i}` for each decoder layer, as the
reference's does.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Tuple

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

# ---- ZiRa rep branches
_rule(r"rep_linear_adapter\.weight$", "rep_linear_adapter/branch_kernel", _LIN)
_rule(r"rep_linear_adapter\.bias$", "rep_linear_adapter/branch_bias")
_rule(r"rep_linear_adapter\.scaling$", "rep_linear_adapter/scaling")
_rule(r"rep_linear_adapter\.freeze_linear\.weight$", "rep_linear_adapter/freeze_kernel", _LIN)
_rule(r"rep_linear_adapter\.freeze_linear\.bias$", "rep_linear_adapter/freeze_bias")
_rule(r"input_proj_conv_adapter\.(\d+)\.weight$",
      r"input_proj_conv_adapter_\1/branch_kernel", _CONV)
_rule(r"input_proj_conv_adapter\.(\d+)\.bias$", r"input_proj_conv_adapter_\1/branch_bias")
_rule(r"input_proj_conv_adapter\.(\d+)\.scaling$", r"input_proj_conv_adapter_\1/scaling")
_rule(r"input_proj_conv_adapter\.(\d+)\.freeze_conv\.weight$",
      r"input_proj_conv_adapter_\1/freeze_kernel", _CONV)
_rule(r"input_proj_conv_adapter\.(\d+)\.freeze_conv\.bias$",
      r"input_proj_conv_adapter_\1/freeze_bias")

# ---- transformer top level
_rule(r"transformer\.level_embed$", "transformer/level_embed")
_rule(r"transformer\.tgt_embed\.weight$", "transformer/tgt_embed")
_lin_rules(r"transformer\.enc_output", "transformer/enc_output")
_ln_rules(r"transformer\.enc_output_norm", "transformer/enc_output_norm")
for _j in range(3):
    _lin_rules(rf"transformer\.enc_out_bbox_embed\.layers\.{_j}",
               rf"enc_out_bbox_embed/layers_{_j}")

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

# ---- heads: the canonical copy of the shared box head
for _j in range(3):
    _lin_rules(rf"bbox_embed\.0\.layers\.{_j}", rf"bbox_embed/layers_{_j}")


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


def jax_params_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params (nested dict of arrays, the "params" collection or a dict
    holding it) -> state_dict with the reference's keys, float32 tensors.
    Raises on a leaf that no rule maps."""
    if "params" in params and isinstance(params["params"], Mapping):
        params = params["params"]
    sd: Dict[str, torch.Tensor] = {}
    unmapped = []
    for path, leaf in _flatten(params).items():
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
    dec_layers = len({k.split(".")[3] for k in sd if k.startswith("transformer.decoder.layers.")})
    for key in [k for k in sd if k.startswith("bbox_embed.0.")]:
        rest = key[len("bbox_embed.0."):]
        for i in range(dec_layers):
            sd[f"bbox_embed.{i}.{rest}"] = sd[key]
            sd[f"transformer.decoder.bbox_embed.{i}.{rest}"] = sd[key]
    return sd
