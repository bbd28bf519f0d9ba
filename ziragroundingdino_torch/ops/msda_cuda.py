"""Wrappers of the hand-written CUDA MSDA kernels:
  * `msda_forward` (`csrc/msda_forward.cu`), the port of the TPU kernel of
    the JAX package's `ops/msda_pallas.py` (`_gather_rows_pallas` fused into
    `ms_deform_attn_pallas`); plain version `msda.ms_deform_attn_plain`;
  * `msda_backward` (`csrc/msda_backward.cu`), the port of the JAX package's
    hand-written MSDA backward (`ops/msda.py::_quad_bwd`); plain version
    `msda.ms_deform_attn_backward_plain`. From `BINNED_MIN_SAMPLES` samples
    on it bins the samples by the d_value tile they write and sums each bin
    in shared memory; smaller calls take the single-pass kernel, whose
    float4 atomics add every corner in L2.

They take CUDA tensors only; they check dtype, shape, contiguity, alignment
and device and raise on anything else. There is no fallback: the CPU path is
chosen by `msda.ms_deform_attn` from the device of its inputs. Each library
is built with nvcc at first use (`cuda_build.load`). The ctypes function of
each kernel and dtype, and the shape checks and level table of each
signature of shapes, are cached; a call costs the checks that depend on the
tensors themselves, the allocations and one foreign call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from ziragroundingdino_torch.ops import cuda_build

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
# pointers (value, loc, attn, [grad_out,] outputs..., [scratch...]), 7 ints, level table, stream
_ARGTYPES = {
    "msda_forward": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2,
    "msda_backward": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2,
    "msda_backward_single_pass": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
    + [ctypes.c_void_p] * 2,
}
HEAD_DIMS = (4, 8, 16, 32)  # the D that the kernels are instantiated for
MAX_LEVELS = 8
MAX_SAMPLES = 31  # L * P: the widest tile's staged loc/attn must fit 48 KB of shared memory
# the backward's bins, checked against the library's `msda_backward_constants`
# when it is loaded
TILE = 8  # cells per side of a d_value tile; a bin's window is TILE + 1 cells a side
CHUNK = 1024  # records of one accumulate block, at most
MAX_TILES = 8192  # tiles of one (b, h) over all levels
MAX_Q = 1 << 24  # queries: a record keeps q in 24 bits
# samples (B*Q*H*L*P) from which the backward takes the binned passes. It
# separates the main path's calls: the encoder's 2,585,216 at 800x1216 bin,
# the decoder's 115,200 do not. For uniformly spread samples the binned
# passes overtake the single pass between 460,800 and 921,600 samples
# (`chip_smoke.py` phase 3b's sweep, PERF.md); 2^19 lies in that range.
BINNED_MIN_SAMPLES = 1 << 19
_INT32_MAX = 2**31 - 1


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    lib = cuda_build.load(name)
    if name == "msda_backward":
        got = (ctypes.c_int * 4)()
        lib.msda_backward_constants.restype = ctypes.c_int
        if lib.msda_backward_constants(got) != 4 or tuple(got) != (TILE, CHUNK, MAX_TILES,
                                                                    MAX_Q):
            raise RuntimeError(f"msda_backward: the library's bins ({tuple(got)}) do not match "
                               f"the wrapper's (TILE, CHUNK, MAX_TILES, MAX_Q)")
    return lib


@functools.lru_cache(maxsize=None)
def _function(kernel: str, dtype: torch.dtype):
    library = "msda_forward" if kernel == "msda_forward" else "msda_backward"
    fn = getattr(_library(library), f"{kernel}_{_SUFFIX[dtype]}")
    fn.argtypes = _ARGTYPES[kernel]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=256)
def _plan(vshape, vdtype, lshape, ldtype, ashape, adtype, shapes):
    """The checks that depend only on shapes and dtypes, made once per
    signature (a check that fails raises and caches nothing). Returns the
    kernel's integer arguments, the output shape and the C array of level
    shapes whose address is among the arguments (the cache keeps it alive)."""
    if vdtype not in _SUFFIX:
        raise ValueError(f"msda: value dtype {vdtype} is not float32 or bfloat16")
    if ldtype != torch.float32 or adtype != torch.float32:
        raise ValueError("msda: sampling_locations and attention_weights must be float32")
    if len(vshape) != 4:
        raise ValueError(f"msda: value must be [B, S, H, D], got {vshape}")
    b, s, h, d = vshape
    if d not in HEAD_DIMS:
        raise ValueError(f"msda: head dim D={d} is not one of {HEAD_DIMS}")
    if len(lshape) != 6 or lshape[-1] != 2:
        raise ValueError(f"msda: sampling_locations must be [B, Q, H, L, P, 2], "
                         f"got {lshape}")
    _, q, _, n_levels, n_points, _ = lshape
    if lshape[:3] != (b, q, h):
        raise ValueError("msda: sampling_locations do not match value in B or H")
    if ashape != (b, q, h, n_levels, n_points):
        raise ValueError(f"msda: attention_weights must be "
                         f"{(b, q, h, n_levels, n_points)}, got {ashape}")
    if len(shapes) != n_levels or not 1 <= n_levels <= MAX_LEVELS:
        raise ValueError(
            f"msda: {len(shapes)} spatial shapes for {n_levels} levels (1..{MAX_LEVELS})")
    if n_levels * n_points > MAX_SAMPLES:
        raise ValueError(f"msda: L*P={n_levels * n_points} samples exceed {MAX_SAMPLES}")
    if sum(hh * ww for hh, ww in shapes) != s:
        raise ValueError(f"msda: spatial_shapes {shapes} do not sum to S={s}")
    level_hw = (ctypes.c_int * (2 * n_levels))(*[v for hw in shapes for v in hw])
    args = (b, s, h, d, q, n_levels, n_points, ctypes.addressof(level_hw))
    return args, (b, q, h * d), level_hw


@functools.lru_cache(maxsize=256)
def _scratch_sizes(b, q, h, n_levels, n_points, shapes):
    """The binned passes' scratch, checked against the kernels' 32-bit
    limits: (int32s of the bin counts, which the caller zeroes; int32s of
    the chunk table and of the records, in one buffer)."""
    n_tiles = sum(-(-hh // TILE) * -(-ww // TILE) for hh, ww in shapes)
    if n_tiles > MAX_TILES:
        raise ValueError(f"msda_backward: {n_tiles} tiles of {TILE}x{TILE} cells per (b, h) "
                         f"exceed {MAX_TILES}")
    if q >= MAX_Q:
        raise ValueError(f"msda_backward: Q={q} queries, the kernel takes fewer than {MAX_Q}")
    n_samples = b * q * h * n_levels * n_points
    n_bins = b * h * n_tiles
    n_chunks = n_bins + -(-n_samples // CHUNK)  # at most one per bin plus one per CHUNK records
    if n_samples > _INT32_MAX or n_chunks + 1 > _INT32_MAX:
        raise ValueError(f"msda_backward: {n_samples} samples exceed the kernel's 32-bit indices")
    return n_bins + 1, (4 * n_chunks, 4 * n_samples)


def _pointers(kernel: str, tensors, dev: int):
    """Data pointers of (name, tensor) pairs, each checked to be a contiguous,
    16-byte aligned tensor on CUDA device `dev` that requires no grad."""
    ptrs = []
    for name, t in tensors:
        if t.requires_grad:
            raise ValueError(f"{kernel}: {name} requires grad; the kernel is not differentiable")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")
        ptrs.append(t.data_ptr())
        if ptrs[-1] % 16:
            raise ValueError(f"{kernel}: {name} is not 16-byte aligned")
        if not t.is_cuda:
            raise ValueError(f"{kernel}: {name} is on {t.device}, not a CUDA device")
        if t.get_device() != dev:
            raise ValueError(f"{kernel}: {name} is on {t.device}, the first input on cuda:{dev}")
    return ptrs


def _launch(kernel: str, dtype: torch.dtype, dev: int, args) -> None:
    fn = _function(kernel, dtype)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with CUDA error {err}")


def _shapes_plan(value, spatial_shapes, sampling_locations, attention_weights):
    return _plan(
        tuple(value.shape), value.dtype, tuple(sampling_locations.shape),
        sampling_locations.dtype, tuple(attention_weights.shape), attention_weights.dtype,
        tuple((int(hh), int(ww)) for hh, ww in spatial_shapes))


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
    args, out_shape, _ = _shapes_plan(value, spatial_shapes, sampling_locations,
                                      attention_weights)
    dev = value.get_device()
    ptrs = _pointers("msda_forward", (("value", value), ("sampling_locations",
                                      sampling_locations),
                                      ("attention_weights", attention_weights)), dev)
    out = torch.empty(out_shape, dtype=value.dtype, device=value.device)
    _launch("msda_forward", value.dtype, dev, (*ptrs, out.data_ptr(), *args))
    msda_forward.launches += 1
    return out


msda_forward.launches = 0


def msda_backward(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    grad_out: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """MSDA backward on the card: the inputs of `msda_forward` and the
    gradient of its output ([B, Q, H*D], the value dtype). Returns (d_value
    in the value dtype, d_sampling_locations f32, d_attention_weights f32).
    d_value is summed in an f32 buffer with atomic adds (run to run, in an
    order that varies) and cast once at the end. A call of at least
    `BINNED_MIN_SAMPLES` samples takes the binned passes (count, scan,
    records, main, accumulate), which sum each bin in shared memory first, and
    counts one more launch in `msda_backward.binned_launches`; a smaller one
    takes the single-pass kernel. Every call counts one launch."""
    args, out_shape, _ = _shapes_plan(value, spatial_shapes, sampling_locations,
                                      attention_weights)
    if grad_out.dtype != value.dtype or tuple(grad_out.shape) != out_shape:
        raise ValueError(f"msda_backward: grad_out must be {out_shape} {value.dtype}, got "
                         f"{tuple(grad_out.shape)} {grad_out.dtype}")
    binned = attention_weights.numel() >= BINNED_MIN_SAMPLES
    if binned:
        n_bins, parts = _scratch_sizes(*attention_weights.shape,
                                       tuple((int(hh), int(ww)) for hh, ww in spatial_shapes))
    dev = value.get_device()
    ptrs = _pointers("msda_backward", (("value", value), ("sampling_locations",
                                       sampling_locations),
                                       ("attention_weights", attention_weights),
                                       ("grad_out", grad_out)), dev)
    d_value = torch.zeros(value.shape, dtype=torch.float32, device=value.device)
    d_loc = torch.empty_like(sampling_locations)
    d_attn = torch.empty_like(attention_weights)
    outs = (d_value.data_ptr(), d_loc.data_ptr(), d_attn.data_ptr())
    if binned:
        bins = torch.zeros(n_bins, dtype=torch.int32, device=value.device)
        # the chunk table and the records
        chunks, records = torch.empty(sum(parts), dtype=torch.int32,
                                      device=value.device).split(parts)
        _launch("msda_backward", value.dtype, dev,
                (*ptrs, *outs, bins.data_ptr(), chunks.data_ptr(), records.data_ptr(), *args))
        msda_backward.binned_launches += 1
    else:
        _launch("msda_backward_single_pass", value.dtype, dev, (*ptrs, *outs, *args))
    msda_backward.launches += 1
    return d_value.to(value.dtype), d_loc, d_attn


msda_backward.launches = 0
msda_backward.binned_launches = 0
