"""The fusion layers' attention core as the benchmark counts it: its least
time on the card and the calls a serving run makes.

`fusion_attn_bound` counts the function's work once, whatever implements
it: q_v, val_v, k_l, val_l ([B, N, heads * hd] in the compute dtype) and the
two masks read once, out_v and out_l written once, and its three products
(S = q_v k_l^T, P_v val_l, P_l^T val_v), 2 * B * heads * Nv * Nl * hd
operations each. The bound is the longer of the bytes at the HBM rate and
the operations at the bf16 rate, as `counts.msda_forward_bound`.

`fusion_calls` lists the calls of the profiled requests: one per encoder
layer when the configuration has fusion layers, at the shapes the graph
runs (the batch bucket, every level's token of the image bucket, the text
bucket).
"""

from __future__ import annotations

from typing import List, Tuple

from benchmark.lib.counts import HBM_BYTES_PER_S, PEAK_BF16_FLOPS, conf_level_shapes

# device kernels of the family, matched by name: image->text, text->image
# (`fusion_attn_kernel`) and the splits' combine (`fusion_attn_combine`)
KERNELS = "fusion_attn_"
LAUNCHES_PER_CALL = 3


def fusion_attn_bound(b: int, nv: int, nl: int, heads: int = 4, hd: int = 256,
                      value_bytes: int = 2) -> Tuple[float, int]:
    """(least seconds, bytes) of one call at B images, Nv image tokens and Nl
    text tokens."""
    e = heads * hd
    nbytes = (3 * b * nv * e + 3 * b * nl * e) * value_bytes + b * (nv + nl)
    flops = 3 * 2 * b * heads * nv * nl * hd
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS), nbytes


def fusion_shape(conf) -> Tuple[int, int]:
    """(heads, head dim) of the configuration's fusion layers."""
    m = conf["model"]
    heads = m["nheads"] // 2
    return heads, (m["dim_feedforward"] // 2) // heads


def fusion_calls(ctx) -> List[Tuple[int, int, int]]:
    """(B, Nv, Nl) of every fusion call of the profiled requests."""
    m = ctx.conf["model"]
    if not m.get("use_fusion_layer", True):
        return []
    out = []
    for req in ctx.trace.items:
        bsz, bucket, text = ctx.run.key(req)[:3]
        nv = sum(hh * ww for hh, ww in conf_level_shapes(ctx.conf, *bucket))
        out += [(bsz, nv, text)] * m["enc_layers"]
    return out
