"""The system under test: the PyTorch and CUDA port, `ziragroundingdino_torch`,
built from a configuration file with the benchmark's seeded weights. The
harness reaches the port only through this module, `serve.py` and
`train.py`."""

from __future__ import annotations

from typing import Dict

import torch


def port_config(conf: Dict, remat: bool = False, dtype: str = None):
    """The port's `GroundingDINOConfig` of a configuration file: its preset
    with the file's sizes."""
    from ziragroundingdino_torch.config import BertConfig, SwinConfig, get_model_config

    def tup(v):
        return tuple(v) if isinstance(v, list) else v

    model = {k: tup(v) for k, v in conf["model"].items()}
    if remat:
        model.update(use_checkpoint=True, use_transformer_ckpt=True)
    if dtype is not None:
        model["compute_dtype"] = dtype
    swin = {k: tup(v) for k, v in conf["swin"].items()}
    return get_model_config(conf["preset"], backbone=conf["backbone"],
                            swin_config=SwinConfig(**swin), bert_config=BertConfig(**conf["bert"]),
                            **model)


def build(conf: Dict, state: Dict[str, torch.Tensor], device: torch.device,
          remat: bool = False, dtype: str = None):
    """The port's model on `device`, in eval mode, its parameters copied from
    `state` (the reference checkpoint's keys, strict)."""
    from ziragroundingdino_torch.models.groundingdino import GroundingDINO

    cfg = port_config(conf, remat, dtype)
    with torch.device("meta"):
        model = GroundingDINO(cfg)
    model = model.to_empty(device=device)
    model.load_state_dict(state, strict=True)
    return model.eval()
