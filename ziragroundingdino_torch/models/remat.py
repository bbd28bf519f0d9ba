"""Activation recomputation ("remat"), the port of the JAX package's
`nn.remat` of Swin's blocks (`SwinConfig.use_checkpoint`), the fusion
layers (`use_checkpoint`) and the deformable encoder layers
(`use_transformer_ckpt`): the layer's activations are dropped after the
forward and recomputed in the backward, trading compute for memory.

`torch.utils.checkpoint` stashes only the global CPU and CUDA generators,
while the port draws dropout and stochastic depth from the explicit
generator passed down the forward: a plain checkpoint would draw other
masks in the recompute, and the gradients would be wrong. `checkpoint`
saves that generator's state before the forward, restores it for the
recompute and leaves the generator where the forward left it, so a step
with remat gives the same losses and gradients as one without.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint as _torch_checkpoint


def checkpoint(fn: Callable, *args, generator: Optional[torch.Generator] = None):
    """`fn(*args)` with its activations recomputed in the backward.
    `generator` is the one `fn` draws from (the caller passes it to `fn`
    among `args`), or None. Without autograd (eval, serving,
    `inference_mode`) `fn` runs as it is, as JAX's remat does in a forward
    alone."""
    if not torch.is_grad_enabled():
        return fn(*args)
    start = None if generator is None else generator.get_state()
    calls = [0]

    def run(*a):
        calls[0] += 1
        if start is None or calls[0] == 1:
            return fn(*a)
        # the recompute: draw from where the forward drew, then put the
        # generator back (the recompute may stop early, hence finally)
        after = generator.get_state()
        generator.set_state(start)
        try:
            return fn(*a)
        finally:
            generator.set_state(after)

    return _torch_checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)
