"""The core of the fusion layers' bi-directional attention
(`models/fusion.py::BiMultiHeadAttention` on the inference path): the plain
PyTorch version, the wrapper of the hand-written CUDA kernel
(`csrc/fusion_attn.cu`), and the device dispatch.

From the projections' outputs in their [B, N, h*hd] layout (q_v, the image
queries already scaled by hd**-0.5; k_l; val_v; val_l) and the masks [B, Nv],
[B, Nl] (True = valid, or None), per head, with S = q_v k_l^T in f32:

    out_v = softmax over Nl (S, keys masked by mask_l) val_l    [B, Nv, h*hd]
    out_l = softmax over Nv (S^T, keys masked by mask_v) val_v  [B, Nl, h*hd]

A masked key's logit is `NEG_INF`, so a row whose keys are all masked
averages them all. The softmaxes are f32; the probabilities are cast to the
values' dtype as the value products' operands, which sum in f32; the
outputs are in the values' dtype. This is the parent's arithmetic but for S,
which the parent rounded to the compute dtype before its f32 softmax.

`fusion_attention_plain` is that function in PyTorch, on any device (the CPU
path, and the kernel's yardstick on the card). `fusion_attention_cuda`
launches the kernel family (image->text, text->image over `split_plan`'s
splits of Nv, and their combine) on the current stream, allocating only
through `torch.empty`, so it can be captured in a CUDA graph; it takes bf16
CUDA tensors at a head dim in `HEAD_DIMS` and raises on anything else.
`fusion_attention` picks one by the inputs' device; `fusion_attention.launches`
counts the kernel family's calls.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ziragroundingdino_torch.ops import cuda_build

HEAD_DIMS = (32, 256)  # the head dims the kernel is instantiated for
BLOCK_ROWS = 64  # query rows a block (`csrc/fusion_attn.cu::kBM`)
CHUNK_KEYS = 32  # keys a chunk (`kBN`)
# text->image blocks at most: one wave of two an SM of the H100's 132, which
# the kernel's shared memory (101 KB) and registers (255 a thread) allow
TARGET_BLOCKS = 264
# a masked key's logit: `models/layers.py::NEG_INF` (not imported: the models
# package imports this module) and the kernel's `kMaskedLogit`
NEG_INF = -1.0e9


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, e = t.shape
    return t.reshape(b, n, heads, e // heads).transpose(1, 2)


def fusion_attention_plain(q_v: torch.Tensor, k_l: torch.Tensor, val_v: torch.Tensor,
                           val_l: torch.Tensor, mask_v: Optional[torch.Tensor],
                           mask_l: Optional[torch.Tensor],
                           heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The function in PyTorch; see the module doc. Returns (out_v, out_l)."""
    b, nv, e = q_v.shape
    nl = k_l.shape[1]
    cd = val_v.dtype
    logits = torch.matmul(_heads(q_v, heads).float(),
                          _heads(k_l, heads).float().transpose(-1, -2))  # [B, h, Nv, Nl]
    logits_l = logits.transpose(-1, -2)  # [B, h, Nl, Nv]
    if mask_v is not None:
        logits_l = logits_l.masked_fill(~mask_v[:, None, None, :], NEG_INF)
    attn_l = torch.softmax(logits_l, dim=-1)
    if mask_l is not None:
        logits = logits.masked_fill(~mask_l[:, None, None, :], NEG_INF)
    attn_v = torch.softmax(logits, dim=-1)
    out_v = torch.matmul(attn_v.to(cd), _heads(val_l, heads))  # [B, h, Nv, hd]
    out_l = torch.matmul(attn_l.to(cd), _heads(val_v, heads))  # [B, h, Nl, hd]
    return (out_v.transpose(1, 2).reshape(b, nv, e),
            out_l.transpose(1, 2).reshape(b, nl, e))


def split_plan(b: int, heads: int, nl: int, nv: int) -> Tuple[int, int]:
    """(splits, keys a split) of the text->image pass: Nv cut into whole
    chunks so that its B * heads * ceil(Nl / BLOCK_ROWS) query tiles make
    as many blocks as one wave of TARGET_BLOCKS holds (at least one split),
    no split empty. A function of the shapes alone (no sync under graph
    capture)."""
    tiles = b * heads * -(-nl // BLOCK_ROWS)
    chunks = -(-nv // CHUNK_KEYS)
    splits = min(chunks, max(1, TARGET_BLOCKS // tiles))
    per = -(-chunks // splits) * CHUNK_KEYS
    return -(-nv // per), per


@functools.lru_cache(maxsize=None)
def _function():
    lib = cuda_build.load("fusion_attn")
    got = (ctypes.c_int * 8)()
    lib.fusion_attn_head_dims.restype = ctypes.c_int
    n = lib.fusion_attn_head_dims(got, len(got))
    if tuple(got[:n]) != HEAD_DIMS:
        raise RuntimeError(f"fusion_attn: the library's head dims {tuple(got[:n])} are not "
                           f"the wrapper's {HEAD_DIMS}")
    fn = lib.fusion_attn_bf16
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q_v, k_l, val_v, val_l, mask_v, mask_l, heads):
    """Raise on what the kernel does not take; returns (B, Nv, Nl, E, hd)."""
    if q_v.dim() != 3 or k_l.dim() != 3:
        raise ValueError(f"fusion_attn: q_v and k_l must be [B, N, E], got "
                         f"{tuple(q_v.shape)} and {tuple(k_l.shape)}")
    b, nv, e = q_v.shape
    nl = k_l.shape[1]
    if tuple(val_v.shape) != (b, nv, e) or tuple(k_l.shape) != (b, nl, e) \
            or tuple(val_l.shape) != (b, nl, e):
        raise ValueError(f"fusion_attn: val_v must be {(b, nv, e)}, k_l and val_l "
                         f"{(b, nl, e)}, got {tuple(val_v.shape)}, {tuple(k_l.shape)}, "
                         f"{tuple(val_l.shape)}")
    if heads <= 0 or e % heads or e // heads not in HEAD_DIMS:
        raise ValueError(f"fusion_attn: E={e} over {heads} heads is not a head dim of "
                         f"{HEAD_DIMS}")
    if nv == 0 or nl == 0:
        raise ValueError(f"fusion_attn: Nv={nv} and Nl={nl} must be positive")
    if b * heads > 65535:
        raise ValueError(f"fusion_attn: B * heads = {b * heads} exceed the kernel's grid")
    dev = q_v.device
    tensors = (("q_v", q_v), ("k_l", k_l), ("val_v", val_v), ("val_l", val_l))
    for name, t in tensors:
        if t.dtype != torch.bfloat16:
            raise ValueError(f"fusion_attn: {name} is {t.dtype}, the kernel takes bfloat16")
        if t.requires_grad:
            raise ValueError(f"fusion_attn: {name} requires grad; the kernel is not "
                             f"differentiable")
    for name, m, n in (("mask_v", mask_v, nv), ("mask_l", mask_l, nl)):
        if m is not None and (m.dtype != torch.bool or tuple(m.shape) != (b, n)
                              or m.device != dev):
            raise ValueError(f"fusion_attn: {name} must be bool {(b, n)} on {dev}, got "
                             f"{m.dtype} {tuple(m.shape)} on {m.device}")
    for name, t in tensors:
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"fusion_attn: {name} is on {t.device}, not the CUDA device of "
                             f"q_v")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"fusion_attn: {name} is not contiguous and 16-byte aligned")
    return b, nv, nl, e, e // heads


def fusion_attention_cuda(q_v: torch.Tensor, k_l: torch.Tensor, val_v: torch.Tensor,
                          val_l: torch.Tensor, mask_v: Optional[torch.Tensor],
                          mask_l: Optional[torch.Tensor],
                          heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel family on the card; see the module doc. Returns (out_v,
    out_l) in bf16; counts one call in `fusion_attention.launches`."""
    b, nv, nl, e, hd = _check(q_v, k_l, val_v, val_l, mask_v, mask_l, heads)
    splits, per = split_plan(b, heads, nl, nv)
    masks = [None if m is None else m.contiguous() for m in (mask_v, mask_l)]
    out_v = torch.empty(b, nv, e, dtype=torch.bfloat16, device=q_v.device)
    out_l = torch.empty(b, nl, e, dtype=torch.bfloat16, device=q_v.device)
    rows = b * heads * splits * nl
    part_o, part_ml = torch.empty(rows * (hd + 2), dtype=torch.float32,
                                  device=q_v.device).split((rows * hd, rows * 2))
    ptrs = [t.data_ptr() for t in (q_v, k_l, val_v, val_l)]
    ptrs += [None if m is None else m.data_ptr() for m in masks]
    ptrs += [t.data_ptr() for t in (out_v, out_l, part_o, part_ml)]
    dev = q_v.get_device()
    with torch.cuda.device(dev):
        err = _function()(*ptrs, b, heads, hd, nv, nl, e, splits, per,
                          torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fusion_attn: kernel launch failed with CUDA error {err}")
    fusion_attention.launches += 1
    return out_v, out_l


def fusion_attention(q_v: torch.Tensor, k_l: torch.Tensor, val_v: torch.Tensor,
                     val_l: torch.Tensor, mask_v: Optional[torch.Tensor],
                     mask_l: Optional[torch.Tensor],
                     heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """CPU tensors take `fusion_attention_plain`, CUDA tensors the kernel
    (`fusion_attention_cuda`, which raises on what it does not take)."""
    if q_v.device.type == "cpu":
        return fusion_attention_plain(q_v, k_l, val_v, val_l, mask_v, mask_l, heads)
    return fusion_attention_cuda(q_v, k_l, val_v, val_l, mask_v, mask_l, heads)


fusion_attention.launches = 0
