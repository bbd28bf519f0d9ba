"""Seeded weights, made on the device from `--seed` by the benchmark itself.

One state dict by the reference checkpoint's key names (`state_shapes` of
`benchmark/reference/model.py`), loaded into the measured model and handed
to the reference alike. The values come from one `torch.rand` call on a
generator of the run's device, seeded with the run's seed, then one affine
map per tensor (two `repeat_interleave`s and a multiply-add over the whole
buffer): a few large calls whatever the number of tensors. Keys that alias
one module (the box head shared by every decoder layer) share one tensor.

The distributions stand in for a trained checkpoint, which is absent: every
matrix has a standard deviation of 1/sqrt(fan_in), so activations keep
their scale through the stacks; norms scale by 1 + U(-0.1, 0.1); biases are
U(-0.02, 0.02); the fusion layers' gammas and the ZiRa branches' scalings
are 0.1 +- 0.05, so that the fusion and the branches do real work; the
sampling offsets' biases reach +-4 feature pixels; the box heads' last
layers are a tenth of the rest, so that boxes move around their anchors
without saturating.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Tuple

import torch

_ALIAS = re.compile(r"^(transformer\.decoder\.)?bbox_embed\.\d+\.")


def canonical(key: str) -> str:
    """The key that holds an aliased tensor's values."""
    return _ALIAS.sub("bbox_embed.0.", key)


def rule(key: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(half-width, centre) of the uniform distribution of a tensor."""
    name = key.rsplit(".", 1)[-1]
    norm = re.search(r"(norm\w*|LayerNorm)\.weight$", key) or re.search(
        r"input_proj\.\d+\.1\.weight$", key)
    if norm:
        return 0.1, 1.0
    if name in ("gamma_v", "gamma_l", "scaling"):
        return 0.05, 0.1
    if key.endswith("sampling_offsets.bias"):
        return 4.0, 0.0
    if name in ("level_embed",) or key.endswith("tgt_embed.weight"):
        return math.sqrt(3.0), 0.0
    if "embeddings." in key or name == "relative_position_bias_table":
        return 0.02 * math.sqrt(3.0), 0.0
    if len(shape) == 1:
        return 0.02, 0.0
    fan_in = math.prod(shape[1:])
    bound = math.sqrt(3.0 / fan_in)
    if re.search(r"bbox_embed\.\d+\.layers\.2\.weight$|enc_out_bbox_embed\.layers\.2\.weight$",
                 key) or key.endswith("sampling_offsets.weight"):
        bound *= 0.1
    return bound, 0.0


def make_state_dict(shapes: Dict[str, Tuple[int, ...]], seed: int,
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """{key: float32 tensor on `device`} from `seed`; see the module doc."""
    own = [k for k in shapes if canonical(k) == k]
    sizes = [math.prod(shapes[k]) for k in own]
    rules = [rule(k, shapes[k]) for k in own]
    total = sum(sizes)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(total, generator=gen, device=device)
    counts = torch.tensor(sizes, device=device)
    half = torch.repeat_interleave(torch.tensor([r[0] for r in rules], device=device), counts,
                                   output_size=total)
    centre = torch.repeat_interleave(torch.tensor([r[1] for r in rules], device=device), counts,
                                     output_size=total)
    flat = flat.mul_(2.0).sub_(1.0).mul_(half).add_(centre)
    del half, centre
    out, start = {}, 0
    for k, n in zip(own, sizes):
        out[k] = flat[start:start + n].view(shapes[k])
        start += n
    return {k: out[canonical(k)] for k in shapes}
