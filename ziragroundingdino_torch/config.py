"""Typed configuration of the PyTorch port.

The port's own copy of the part of the JAX package's `config.py` that
its serving, training and lifecycle paths read: `SwinConfig`, `BertConfig`,
`GroundingDINOConfig`, `DataConfig`, `TrainConfig`, `load_config_overrides`
and the presets of the vanilla model and of the ZiRa family
(`MODEL_PRESETS`). Field names and defaults are those of the JAX package,
so one set of overrides configures both.
`OptimizerConfig` and `ScheduleConfig` are the train step's
(`train/optim.py`), `TrainConfig` the trainer's (`train/trainer.py`). `compute_dtype` names a `torch.dtype`; there is no
`msda_impl`: the port has one MSDA and dispatches on the device. The
presets are the JAX package's 12, and every switch that the JAX model
reads is here: the backbone (`SWIN_VARIANTS` or `resnet50`/`resnet101`),
the position embedding, the ablation switches of the encoder and decoder
and the remat switches. JAX's `GroundingDINOConfig` holds ten more fields
that no code of that package reads (`query_dim`, `num_patterns`,
`two_stage_type`, `dec_pred_bbox_embed_share`, `two_stage_bbox_embed_share`,
`text_encoder_type`, `use_prompt_memory`, `use_prompt_memory_output`,
`sub`) or that the port has no use for (`msda_impl`); they are left out.
"""

from __future__ import annotations

import dataclasses
import json
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
    use_checkpoint: bool = False  # recompute each block in the backward (`models/remat.py`)

    @property
    def num_layers(self) -> int:
        return len(self.depths)

    @property
    def num_features(self) -> Tuple[int, ...]:
        return tuple(int(self.embed_dim * 2**i) for i in range(len(self.depths)))


SWIN_VARIANTS: Dict[str, SwinConfig] = {
    # `backbone/swin_transformer.py:771-787`
    "swin_T_224_1k": SwinConfig(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24)),
    "swin_B_224_22k": SwinConfig(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32)),
    "swin_B_384_22k": SwinConfig(
        embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32), window_size=12),
    "swin_L_224_22k": SwinConfig(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48)),
    "swin_L_384_22k": SwinConfig(
        embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48), window_size=12),
}
# the torchvision alternative (`backbone/backbone.py:33-71`): blocks per stage
RESNET_DEPTHS: Dict[str, Tuple[int, ...]] = {"resnet50": (3, 4, 6, 3),
                                             "resnet101": (3, 4, 23, 3)}


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
    serving path, the train step and the lifecycle read are kept."""

    modelname: str = "dualzerorepbranchgroundingdino"
    # a key of SWIN_VARIANTS or RESNET_DEPTHS
    backbone: str = "swin_T_224_1k"
    # "sine", or "learned" (also "v3"): a 50-row table per axis
    position_embedding: str = "sine"
    pe_temperature_h: float = 20.0
    pe_temperature_w: float = 20.0
    return_interm_indices: Tuple[int, ...] = (1, 2, 3)
    enc_layers: int = 6
    dec_layers: int = 6
    dim_feedforward: int = 2048
    hidden_dim: int = 256
    dropout: float = 0.0
    nheads: int = 8
    num_queries: int = 900
    num_feature_levels: int = 4
    enc_n_points: int = 4
    dec_n_points: int = 4
    transformer_activation: str = "relu"
    # the encoder-output class head is the decoder's (always so without
    # `use_cls_linear`, whose head has parameters)
    two_stage_class_embed_share: bool = False
    # False: the decoder starts from the selected encoder memory, detached,
    # instead of the learned `tgt_embed`
    embed_init_tgt: bool = True
    max_text_len: int = 256
    # the ablation switches: without them the encoder has no text layers,
    # no fusion layers, the decoder no text cross-attention
    use_text_enhancer: bool = True
    use_fusion_layer: bool = True
    use_text_cross_attention: bool = True
    # remat (`models/remat.py`): the fusion layers, and the deformable
    # encoder layers; Swin's blocks follow `SwinConfig.use_checkpoint`
    use_checkpoint: bool = False
    use_transformer_ckpt: bool = False
    text_dropout: float = 0.0
    fusion_dropout: float = 0.0
    fusion_droppath: float = 0.1
    # False: BERT sees the plain [B, T] token mask and default positions
    # instead of the per-phrase block mask and position ids
    sub_sentence_present: bool = True
    # train
    aux_loss: bool = True
    freeze_all: bool = True  # False: every parameter trains (the finetune preset)
    # test: detections kept per image by the evaluator
    select_box_nums_for_evaluation: int = 200
    # task-agnostic caption augmentation (`groundingdino_dt.py:452-460`):
    # append up to num_select_prompt learned class names to a task's caption
    use_add_names: bool = False
    use_learned_names: bool = False
    num_select_prompt: int = 20
    # in-layer encoder and decoder adapters (CAT, `GroundingDINO_SwinT_OGC_cat.py`)
    use_adapter: bool = False
    use_self_kd: bool = False
    encoder_gate_base_scale: float = 0.1
    decoder_gate_base_scale: float = 0.1
    # the language-side branch (the CET adapter of the dt model; the ZiRa
    # language branch in the ZiRa family, `groundingdino_dt.py:182-206`)
    use_cet: bool = True
    cet_middle_dim: int = 1024
    cet_type: str = "Adapter"  # "Adapter", "Linear" or "Transformer"
    # CAT conditional prompt: an MoE adapter over the pooled deepest level,
    # added to the encoded text (`groundingdino_conditional_adapter_tuning.py:
    # 137-146,366-378`)
    use_prompt: bool = False
    # ZiRa (`GroundingDINO_SwinT_OGC_rep.py:62-96`): the vision branches and
    # the zero-interference losses
    use_zero_inter_loss: bool = True
    use_project_adapter: bool = True
    use_zero_inter_loss_for_conv: bool = True
    loss_adapter_weight: float = 0.1
    zira_zero_init: float = 1e-8
    zira_lan_scale: float = 0.1
    zira_vis_scale: float = 0.1
    # the ZiRa language branch's shape: "linear" (RepZeroLinear) or "lora"
    # (RepZeroLoRA, `groundingdino_dual_zero_rep_branch.py:251-253`)
    zira_lan_adapter: str = "linear"
    zira_lora_down_dim: Optional[int] = None  # None: in_features // 4
    # MoE (`moe.py:144`; the configs use 1 expert)
    num_experts: int = 1
    num_topk_experts: int = 1
    # the other PET baselines' switches: which parameters train
    # (`train/optim.py::trainable_patterns_for_cfg`); `use_cls_linear` also
    # gives the heads a linear projection
    use_bert_tuning: bool = False
    use_cls_linear: bool = False
    use_prompt_tuning: bool = False
    use_project_tuning: bool = False  # train the input projections themselves
    pixel_mean: Tuple[float, float, float] = (123.675, 116.28, 103.53)
    pixel_std: Tuple[float, float, float] = (58.395, 57.12, 57.375)
    # compute dtype of the matmul-heavy paths; parameters stay float32
    compute_dtype: str = "bfloat16"
    max_categories: int = 90
    swin_config: Optional[SwinConfig] = None
    bert_config: Optional[BertConfig] = None

    @property
    def swin(self) -> SwinConfig:
        base = self.swin_config or SWIN_VARIANTS[self.backbone]
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


# the switches of every preset built on the dt scaffold that has neither a
# ZiRa branch nor a zero-interference loss
_NO_ZIRA = dict(use_zero_inter_loss=False, use_project_adapter=False,
                use_zero_inter_loss_for_conv=False)

MODEL_PRESETS: Dict[str, GroundingDINOConfig] = {
    # vanilla inference model (`GroundingDINO_SwinT_OGC.py`): no branch at all
    "groundingdino": GroundingDINOConfig(modelname="groundingdino", use_cet=False, **_NO_ZIRA),
    # detectron2-trainable scaffold with the CET language adapter
    # (`GroundingDINO_SwinT_OGC_dt.py`)
    "dtgroundingdino": GroundingDINOConfig(
        modelname="dtgroundingdino", use_add_names=True, use_learned_names=True,
        loss_adapter_weight=0.005, **_NO_ZIRA),
    # ZiRa headline model (`GroundingDINO_SwinT_OGC_rep.py`)
    "dualzerorepbranchgroundingdino": GroundingDINOConfig(),
    # multilayer-branch variant (`groundingdino_dual_zero_rep_multilayer_branch.py:971`)
    "dualzerorepmultilayerbranchgroundingdino": GroundingDINOConfig(
        modelname="dualzerorepmultilayerbranchgroundingdino"),
    # single-path rep variants, vision branches only (`groundingdino_repconv.py:1041`,
    # `groundingdino_repconvbn.py:1069`)
    "repgroundingdino": GroundingDINOConfig(
        modelname="repgroundingdino", use_cet=False, use_zero_inter_loss=False),
    "repconvbngroundingdino": GroundingDINOConfig(
        modelname="repconvbngroundingdino", use_cet=False, use_zero_inter_loss=False),
    # the PET baselines (`GroundingDINO_SwinT_OGC_dt_{finetuning,linearprobing,
    # prompttuning,berttuning,projecttuning}.py`)
    "finetune": GroundingDINOConfig(modelname="dtgroundingdino", freeze_all=False,
                                    use_cet=False, **_NO_ZIRA),
    "linearprobe": GroundingDINOConfig(modelname="dtgroundingdino", use_cls_linear=True,
                                       use_cet=False, **_NO_ZIRA),
    "prompttune": GroundingDINOConfig(modelname="dtgroundingdino", use_prompt_tuning=True,
                                      use_cet=False, **_NO_ZIRA),
    "berttune": GroundingDINOConfig(modelname="dtgroundingdino", use_bert_tuning=True,
                                    use_cet=False, **_NO_ZIRA),
    "projecttune": GroundingDINOConfig(modelname="dtgroundingdino", use_project_tuning=True,
                                       use_cet=False, **_NO_ZIRA),
    # conditional adapter tuning, CAT (`GroundingDINO_SwinT_OGC_cat.py`)
    "catgroundingdino": GroundingDINOConfig(modelname="catgroundingdino", use_adapter=True,
                                            use_prompt=True, use_cet=False, **_NO_ZIRA),
}


def get_model_config(name: str, **overrides) -> GroundingDINOConfig:
    """Look up a preset by name and apply overrides."""
    if name not in MODEL_PRESETS:
        raise KeyError(f"unknown preset {name!r}: the presets are {sorted(MODEL_PRESETS)}")
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
class OptimizerConfig:
    """AdamW defaults (`config/configs/common/optim.py:16-28` and the task
    configs). `lr_factors`: per-parameter lr multipliers keyed by substring
    of the parameter name, as detectron2's `lr_factor_func`."""

    name: str = "adamw"
    lr: float = 1e-3
    weight_decay: float = 1e-4
    betas: Tuple[float, float] = (0.9, 0.999)
    grad_clip: float = 0.1
    lr_factors: Tuple[Tuple[str, float], ...] = ()


@dataclass(frozen=True)
class ScheduleConfig:
    """Multi-step schedule (`config/configs/common/coco_schedule.py:91-125`):
    x0.1 at 8/9 and 17/18 of the run; also "cosine", "linear", "constant"
    and "exponential", each after an optional linear warmup."""

    name: str = "multistep"
    max_iter: int = 2000
    warmup_iter: int = 0
    warmup_factor: float = 0.001
    milestones_frac: Tuple[float, ...] = (8.0 / 9.0, 17.0 / 18.0)
    gamma: float = 0.1


@dataclass(frozen=True)
class TrainConfig:
    """What the trainer reads (`train/trainer.py`): where it writes, how long
    it runs, how often it logs and checkpoints, and the seed of its
    per-iteration generators. The optimizer's settings are `OptimizerConfig`
    and `ScheduleConfig`."""

    output_dir: str = "./output"
    max_iter: int = 2000
    seed: int = 42
    checkpoint_period: int = 2000
    log_period: int = 20
    fast_dev_run: bool = False  # shrink the run to 20 iterations (`train_net.py:313-317`)


@dataclass(frozen=True)
class DataConfig:
    """Host data config: the multi-scale train augmentation
    (`config/configs/common/data/odinw/aquarium.py:49-60`), the eval resize
    and the static padded (H, W) buckets."""

    train_short_sides: Tuple[int, ...] = (480, 512, 544, 576, 608, 640, 672, 704, 736, 768, 800)
    max_size: int = 1333
    test_short_side: int = 800
    random_flip: bool = True
    shape_buckets: Tuple[Tuple[int, int], ...] = (
        (512, 768), (512, 1024), (768, 1024), (800, 1216), (800, 1344), (1024, 1344),
    )
    pixel_mean: Tuple[float, float, float] = (123.675, 116.28, 103.53)
    pixel_std: Tuple[float, float, float] = (58.395, 57.12, 57.375)
    max_boxes: int = 100  # ground-truth padding bound
    num_workers: int = 2  # loader threads


def load_config_overrides(path: str):
    """Read a `{"model": {...}, "data": {...}}` overrides json (the drivers'
    `--config-overrides`): json lists become tuples, and nested
    `swin_config` / `bert_config` dicts become their dataclasses. Returns
    (model overrides, data overrides) as dicts."""

    def tuplify(v):
        return tuple(tuplify(x) for x in v) if isinstance(v, list) else v

    with open(path) as f:
        ov = json.load(f)
    model = ov.get("model", {})
    model_ov = {k: tuplify(v) for k, v in model.items()}
    for key, cls in (("swin_config", SwinConfig), ("bert_config", BertConfig)):
        if isinstance(model.get(key), dict):
            model_ov[key] = cls(**{k: tuplify(v) for k, v in model[key].items()})
    data_ov = {k: tuplify(v) for k, v in ov.get("data", {}).items()}
    return model_ov, data_ov
