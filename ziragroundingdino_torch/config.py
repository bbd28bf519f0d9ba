"""Typed configuration of the PyTorch port.

The port's own copy of the part of the JAX package's `config.py` that
its serving path reads: `SwinConfig`, `BertConfig`, `GroundingDINOConfig`,
`DataConfig` and the `dualzerorepbranchgroundingdino` preset (the ZiRa
headline model, `GroundingDINO_SwinT_OGC_rep.py` in the reference). Field
names and defaults are those of the JAX package, so one set of overrides
configures both. `compute_dtype` names a `torch.dtype`; there is no
`msda_impl`: the port has one MSDA and dispatches on the device. The
switches that select another preset's architecture (`use_cet`,
`use_project_adapter`, `use_fusion_layer`, `two_stage_type`, ...) are not
fields: the port builds this preset's architecture only.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch


@dataclass(frozen=True)
class SwinConfig:
    """Swin Transformer backbone (`backbone/swin_transformer.py:762-791`);
    the defaults are Swin-T (`swin_T_224_1k`)."""

    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    patch_size: int = 4
    in_chans: int = 3
    drop_path_rate: float = 0.2
    out_indices: Tuple[int, ...] = (1, 2, 3)

    @property
    def num_layers(self) -> int:
        return len(self.depths)

    @property
    def num_features(self) -> Tuple[int, ...]:
        return tuple(int(self.embed_dim * 2**i) for i in range(len(self.depths)))


@dataclass(frozen=True)
class BertConfig:
    """BERT-base-uncased text encoder."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    pad_token_id: int = 0


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class GroundingDINOConfig:
    """Model config; fields as in the JAX package's `GroundingDINOConfig`
    (values from `GroundingDINO_SwinT_OGC_rep.py`). Only the fields that the
    serving path reads are kept."""

    modelname: str = "dualzerorepbranchgroundingdino"
    pe_temperature_h: float = 20.0
    pe_temperature_w: float = 20.0
    return_interm_indices: Tuple[int, ...] = (1, 2, 3)
    enc_layers: int = 6
    dec_layers: int = 6
    dim_feedforward: int = 2048
    hidden_dim: int = 256
    nheads: int = 8
    num_queries: int = 900
    num_feature_levels: int = 4
    enc_n_points: int = 4
    dec_n_points: int = 4
    transformer_activation: str = "relu"
    max_text_len: int = 256
    zira_zero_init: float = 1e-8
    zira_lan_scale: float = 0.1
    zira_vis_scale: float = 0.1
    pixel_mean: Tuple[float, float, float] = (123.675, 116.28, 103.53)
    pixel_std: Tuple[float, float, float] = (58.395, 57.12, 57.375)
    # compute dtype of the matmul-heavy paths; parameters stay float32
    compute_dtype: str = "bfloat16"
    max_categories: int = 90
    swin_config: Optional[SwinConfig] = None
    bert_config: Optional[BertConfig] = None

    @property
    def swin(self) -> SwinConfig:
        base = self.swin_config or SwinConfig()
        return dataclasses.replace(base, out_indices=self.return_interm_indices)

    @property
    def bert(self) -> BertConfig:
        return self.bert_config or BertConfig()

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.nheads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def replace(self, **kw) -> "GroundingDINOConfig":
        return dataclasses.replace(self, **kw)


MODEL_PRESETS: Dict[str, GroundingDINOConfig] = {
    # ZiRa headline model (`GroundingDINO_SwinT_OGC_rep.py`)
    "dualzerorepbranchgroundingdino": GroundingDINOConfig(),
}


def get_model_config(name: str, **overrides) -> GroundingDINOConfig:
    """Look up a preset by name and apply overrides."""
    if name not in MODEL_PRESETS:
        raise KeyError(f"unknown preset {name!r}; the port has {sorted(MODEL_PRESETS)}")
    cfg = MODEL_PRESETS[name]
    return cfg.replace(**overrides) if overrides else cfg


def dtype_name(dtype) -> str:
    """'bfloat16' for torch.bfloat16 or 'bfloat16'."""
    if isinstance(dtype, str):
        if dtype not in _DTYPES:
            raise ValueError(f"unknown dtype {dtype!r}")
        return dtype
    for name, dt in _DTYPES.items():
        if dt == dtype:
            return name
    raise ValueError(f"unsupported compute dtype {dtype}")


@dataclass(frozen=True)
class DataConfig:
    """Host data config: eval resize and the static padded (H, W) buckets."""

    test_short_side: int = 800
    max_size: int = 1333
    shape_buckets: Tuple[Tuple[int, int], ...] = (
        (512, 768), (512, 1024), (768, 1024), (800, 1216), (800, 1344), (1024, 1344),
    )
    pixel_mean: Tuple[float, float, float] = (123.675, 116.28, 103.53)
    pixel_std: Tuple[float, float, float] = (58.395, 57.12, 57.375)
