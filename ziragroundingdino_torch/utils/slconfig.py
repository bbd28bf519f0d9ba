"""The SLConfig shim, the port's copy of the JAX package's
`utils/slconfig.py`: the reference configures a model by exec-ing a flat
Python file (`util/slconfig.py:76-135`, e.g.
`GroundingDINO_SwinB_cfg.py`) whose variables (`modelname`, `backbone`,
`hidden_dim`, ...) feed its registry. `config_from_slconfig` execs such a
file and maps every knob it knows onto the port's `GroundingDINOConfig`
over the preset that `modelname` names, and returns the others, logged.

Exec runs the file's code: load only config files you trust.
"""

from __future__ import annotations

import logging
import types
from typing import Any, Dict, Tuple

from ziragroundingdino_torch.config import MODEL_PRESETS, GroundingDINOConfig

logger = logging.getLogger("ziragroundingdino_torch")

# reference knob -> the config's field (the same name where absent); None:
# a knob the port has no field for (denoising, engine-level settings)
KEY_MAP = {
    "pe_temperatureH": "pe_temperature_h",
    "pe_temperatureW": "pe_temperature_w",
    "dn_box_noise_scale": None,  # the denoising knobs: no shipped driver uses DN
    "dn_label_noise_ratio": None,
    "dn_label_coef": None,
    "dn_bbox_coef": None,
    "use_dn": None,
    "dn_number": None,
    "dn_labelbook_size": None,
    "use_ema": None,  # the trainer's (`--ema-decay`)
    "batch_size": None,
    "use_coco_eval": None,
    "device": None,
    "max_labels": None,
    "lr_backbone": None,
    "backbone_freeze_keywords": None,  # freezing is the optimizer's (`train/optim.py`)
    "pre_norm": None,  # always False (post-norm), which the transformer is
}


def load_slconfig(path: str) -> Dict[str, Any]:
    """Exec a reference model-config file into a dict of its variables
    (`util/slconfig.py:76-135` without the addict wrapper)."""
    ns: Dict[str, Any] = {}
    with open(path) as f:
        code = f.read()
    exec(compile(code, path, "exec"), ns)
    return {k: v for k, v in ns.items()
            if not k.startswith("__") and not isinstance(v, types.ModuleType)}


def config_from_slconfig(path: str) -> Tuple[GroundingDINOConfig, Dict[str, Any]]:
    """(the config, {knob: value} of the knobs it does not set). The base is
    the preset named by the file's `modelname` (the vanilla `groundingdino`
    where it names none the port has); lists become tuples."""
    raw = load_slconfig(path)
    base = MODEL_PRESETS.get(raw.get("modelname", "groundingdino"),
                             MODEL_PRESETS["groundingdino"])
    fields = set(GroundingDINOConfig.__dataclass_fields__)
    overrides: Dict[str, Any] = {}
    ignored: Dict[str, Any] = {}
    for k, v in raw.items():
        field = KEY_MAP.get(k, k)
        if field in fields:
            overrides[field] = tuple(v) if isinstance(v, list) else v
        else:
            ignored[k] = v
    if ignored:
        logger.info("slconfig: ignored keys %s", sorted(ignored))
    return base.replace(**overrides), ignored
