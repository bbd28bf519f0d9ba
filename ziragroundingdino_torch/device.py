"""Where the port runs: the card unless the caller asks for the CPU."""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple, Union

import torch
import torch.distributed


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` means the CUDA card (in a process of a data-parallel group,
    this process's card, `cuda:{LOCAL_RANK}`); with no card that raises
    instead of running on the CPU. Pass `device="cpu"` to run on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        if torch.distributed.is_available() and torch.distributed.is_initialized():
            return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        return torch.device("cuda")
    return torch.device(device)


class DeviceTables:
    """Per-device tensor copies of static tables, each made on first use and
    kept: a forward that reads one makes no copy from the host once it is
    warm, so a CUDA graph can capture it. A table is made outside inference
    mode even when the first call runs in it (`predict`), so that a later
    train step may save it for the backward (`finetune` trains Swin)."""

    def __init__(self):
        self._cache: Dict[Tuple, torch.Tensor] = {}

    def get(self, key: Tuple, device: torch.device, make) -> torch.Tensor:
        k = key + (str(device),)
        t = self._cache.get(k)
        if t is None:
            with torch.inference_mode(False):
                t = torch.as_tensor(make(), device=device)
            self._cache[k] = t
        return t


_CONSTANTS = DeviceTables()


def device_constant(values: Tuple, device: torch.device,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The tensor of `values` (a tuple of numbers, or of tuples) on `device`,
    from a `DeviceTables` shared by the port's modules."""
    return _CONSTANTS.get((values, dtype), device, lambda: torch.tensor(values, dtype=dtype))
