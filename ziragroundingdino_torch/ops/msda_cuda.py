"""Wrapper of the hand-written CUDA MSDA forward kernel
(`csrc/msda_forward.cu`), the port of the TPU kernel
the JAX package's `ops/msda_pallas.py` (`_gather_rows_pallas` fused into
`ms_deform_attn_pallas`). Its plain version is `msda.ms_deform_attn_plain`.

The wrapper takes CUDA tensors only; it checks device, dtype, shape and
contiguity and raises on anything else. There is no fallback: the CPU path
is chosen by `msda.ms_deform_attn` from the device of its inputs. The
library is built with nvcc at first use (`cuda_build.load`).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from ziragroundingdino_torch.ops import cuda_build

_SYMBOLS = {torch.float32: "msda_forward_f32", torch.bfloat16: "msda_forward_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2


def _function(dtype: torch.dtype):
    lib = cuda_build.load("msda_forward")
    fn = getattr(lib, _SYMBOLS[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def msda_forward(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """MSDA forward on the card. value [B, S, H, D] f32 or bf16;
    sampling_locations [B, Q, H, L, P, 2] f32; attention_weights
    [B, Q, H, L, P] f32. Returns [B, Q, H*D] in the value dtype."""
    tensors = {"value": value, "sampling_locations": sampling_locations,
               "attention_weights": attention_weights}
    for name, t in tensors.items():
        if t.requires_grad:
            raise ValueError(f"msda_forward: {name} requires grad; the kernel is forward only")
        if t.device.type != "cuda":
            raise ValueError(f"msda_forward: {name} is on {t.device}, not a CUDA device")
        if t.device != value.device:
            raise ValueError(f"msda_forward: {name} is on {t.device}, value on {value.device}")
        if not t.is_contiguous():
            raise ValueError(f"msda_forward: {name} is not contiguous")
    if value.dtype not in _SYMBOLS:
        raise ValueError(f"msda_forward: value dtype {value.dtype} is not float32 or bfloat16")
    if sampling_locations.dtype != torch.float32 or attention_weights.dtype != torch.float32:
        raise ValueError("msda_forward: sampling_locations and attention_weights must be float32")
    if value.dim() != 4:
        raise ValueError(f"msda_forward: value must be [B, S, H, D], got {tuple(value.shape)}")
    b, s, h, d = value.shape
    if sampling_locations.dim() != 6 or sampling_locations.shape[-1] != 2:
        raise ValueError(
            f"msda_forward: sampling_locations must be [B, Q, H, L, P, 2], "
            f"got {tuple(sampling_locations.shape)}")
    _, q, _, n_levels, n_points, _ = sampling_locations.shape
    if tuple(sampling_locations.shape[:3]) != (b, q, h):
        raise ValueError("msda_forward: sampling_locations do not match value in B or H")
    if tuple(attention_weights.shape) != (b, q, h, n_levels, n_points):
        raise ValueError(
            f"msda_forward: attention_weights must be {(b, q, h, n_levels, n_points)}, "
            f"got {tuple(attention_weights.shape)}")
    shapes = [(int(hh), int(ww)) for hh, ww in spatial_shapes]
    if len(shapes) != n_levels or not 1 <= n_levels <= 8:
        raise ValueError(f"msda_forward: {len(shapes)} spatial shapes for {n_levels} levels (1..8)")
    if sum(hh * ww for hh, ww in shapes) != s:
        raise ValueError(f"msda_forward: spatial_shapes {shapes} do not sum to S={s}")

    out = torch.empty(b, q, h * d, dtype=value.dtype, device=value.device)
    level_hw = (ctypes.c_int * (2 * n_levels))(*[v for hw in shapes for v in hw])
    fn = _function(value.dtype)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream(value.device).cuda_stream
        err = fn(value.data_ptr(), sampling_locations.data_ptr(),
                 attention_weights.data_ptr(), out.data_ptr(),
                 b, s, h, d, q, n_levels, n_points,
                 ctypes.addressof(level_hw), stream)
    if err != 0:
        raise RuntimeError(f"msda_forward: kernel launch failed with CUDA error {err}")
    msda_forward.launches += 1
    return out


msda_forward.launches = 0
