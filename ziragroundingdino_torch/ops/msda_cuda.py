"""Wrapper of the hand-written CUDA MSDA forward kernel
(`csrc/msda_forward.cu`), the port of the TPU kernel
the JAX package's `ops/msda_pallas.py` (`_gather_rows_pallas` fused into
`ms_deform_attn_pallas`). Its plain version is `msda.ms_deform_attn_plain`.

The wrapper takes CUDA tensors only; it checks dtype, shape, contiguity,
alignment and device and raises on anything else. There is no fallback: the
CPU path is chosen by `msda.ms_deform_attn` from the device of its inputs.
The library is built with nvcc at first use (`cuda_build.load`). The ctypes
function of each dtype, and the shape checks and level table of each
signature of shapes, are cached; a call costs the checks that depend on the
tensors themselves, one allocation and one foreign call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from ziragroundingdino_torch.ops import cuda_build

_SYMBOLS = {torch.float32: "msda_forward_f32", torch.bfloat16: "msda_forward_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2
HEAD_DIMS = (4, 8, 16, 32)  # the D that the kernel is instantiated for
MAX_LEVELS = 8
MAX_SAMPLES = 31  # L * P: the widest tile's staged loc/attn must fit 48 KB of shared memory


@functools.lru_cache(maxsize=None)
def _function(dtype: torch.dtype):
    fn = getattr(cuda_build.load("msda_forward"), _SYMBOLS[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=256)
def _plan(vshape, vdtype, lshape, ldtype, ashape, adtype, shapes):
    """The checks that depend only on shapes and dtypes, made once per
    signature (a check that fails raises and caches nothing). Returns the
    kernel's integer arguments, the output shape and the C array of level
    shapes whose address is among the arguments (the cache keeps it alive)."""
    if vdtype not in _SYMBOLS:
        raise ValueError(f"msda_forward: value dtype {vdtype} is not float32 or bfloat16")
    if ldtype != torch.float32 or adtype != torch.float32:
        raise ValueError("msda_forward: sampling_locations and attention_weights must be float32")
    if len(vshape) != 4:
        raise ValueError(f"msda_forward: value must be [B, S, H, D], got {vshape}")
    b, s, h, d = vshape
    if d not in HEAD_DIMS:
        raise ValueError(f"msda_forward: head dim D={d} is not one of {HEAD_DIMS}")
    if len(lshape) != 6 or lshape[-1] != 2:
        raise ValueError(f"msda_forward: sampling_locations must be [B, Q, H, L, P, 2], "
                         f"got {lshape}")
    _, q, _, n_levels, n_points, _ = lshape
    if lshape[:3] != (b, q, h):
        raise ValueError("msda_forward: sampling_locations do not match value in B or H")
    if ashape != (b, q, h, n_levels, n_points):
        raise ValueError(f"msda_forward: attention_weights must be "
                         f"{(b, q, h, n_levels, n_points)}, got {ashape}")
    if len(shapes) != n_levels or not 1 <= n_levels <= MAX_LEVELS:
        raise ValueError(
            f"msda_forward: {len(shapes)} spatial shapes for {n_levels} levels (1..{MAX_LEVELS})")
    if n_levels * n_points > MAX_SAMPLES:
        raise ValueError(f"msda_forward: L*P={n_levels * n_points} samples exceed {MAX_SAMPLES}")
    if sum(hh * ww for hh, ww in shapes) != s:
        raise ValueError(f"msda_forward: spatial_shapes {shapes} do not sum to S={s}")
    level_hw = (ctypes.c_int * (2 * n_levels))(*[v for hw in shapes for v in hw])
    args = (b, s, h, d, q, n_levels, n_points, ctypes.addressof(level_hw))
    return args, (b, q, h * d), level_hw


def msda_forward(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """MSDA forward on the card. value [B, S, H, D] f32 or bf16 with D in
    `HEAD_DIMS`; sampling_locations [B, Q, H, L, P, 2] f32; attention_weights
    [B, Q, H, L, P] f32 with L*P at most `MAX_SAMPLES`. Returns [B, Q, H*D] in
    the value dtype."""
    tensors = (("value", value), ("sampling_locations", sampling_locations),
               ("attention_weights", attention_weights))
    for name, t in tensors:
        if t.requires_grad:
            raise ValueError(f"msda_forward: {name} requires grad; the kernel is forward only")
    args, out_shape, _ = _plan(
        tuple(value.shape), value.dtype, tuple(sampling_locations.shape),
        sampling_locations.dtype, tuple(attention_weights.shape), attention_weights.dtype,
        tuple((int(hh), int(ww)) for hh, ww in spatial_shapes))
    dev = value.get_device()
    ptrs = []
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"msda_forward: {name} is not contiguous")
        ptrs.append(t.data_ptr())
        if ptrs[-1] % 16:
            raise ValueError(f"msda_forward: {name} is not 16-byte aligned")
        if not t.is_cuda:
            raise ValueError(f"msda_forward: {name} is on {t.device}, not a CUDA device")
        if t.get_device() != dev:
            raise ValueError(f"msda_forward: {name} is on {t.device}, value on {value.device}")

    out = torch.empty(out_shape, dtype=value.dtype, device=value.device)
    fn = _function(value.dtype)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev == torch.cuda.current_device():
        err = fn(*ptrs, out.data_ptr(), *args, stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*ptrs, out.data_ptr(), *args, stream)
    if err != 0:
        raise RuntimeError(f"msda_forward: kernel launch failed with CUDA error {err}")
    msda_forward.launches += 1
    return out


msda_forward.launches = 0
