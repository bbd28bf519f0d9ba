"""Model construction: `build_model(preset, device=..., dtype=..., seed=...)`."""

from __future__ import annotations

from typing import Optional, Union

import torch

from ziragroundingdino_torch.config import GroundingDINOConfig, dtype_name, get_model_config
from ziragroundingdino_torch.device import resolve_device
from ziragroundingdino_torch.models.groundingdino import GroundingDINO
from ziragroundingdino_torch.models.layers import init_weights


def build_model(
    preset: Union[str, GroundingDINOConfig] = "dualzerorepbranchgroundingdino",
    device: Optional[Union[str, torch.device]] = None,
    dtype: Optional[Union[str, torch.dtype]] = None,
    seed: int = 0,
    **overrides,
) -> GroundingDINO:
    """Build a preset (or a config) in eval mode with seeded random weights.

    device: None means the CUDA card and raises where there is none; pass
    "cpu" to run on the CPU. dtype: the compute dtype (default: the
    config's `compute_dtype`); parameters are float32. The weights are drawn
    on the CPU from `torch.Generator().manual_seed(seed)`, so one seed gives
    the same model on every device.
    """
    dev = resolve_device(device)
    cfg = preset if isinstance(preset, GroundingDINOConfig) else get_model_config(preset)
    if dtype is not None:
        overrides["compute_dtype"] = dtype_name(dtype)
    if overrides:
        cfg = cfg.replace(**overrides)
    with torch.device("meta"):
        model = GroundingDINO(cfg)
    model.to_empty(device="cpu")
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


__all__ = ["GroundingDINO", "build_model"]
