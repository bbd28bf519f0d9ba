"""Sparsely-gated mixture of experts, the port of the JAX package's
`models/moe.py` (reference `models/GroundingDINO/moe.py:120-307`): noisy
top-k gating, the cv^2 importance and load losses, and experts that are
2-layer ReLU MLPs.

Dispatch is dense, as in the JAX package: every expert runs on every token,
and the top-k gate matrix [N, E] (zero outside each token's top k) combines
their outputs. Parameter names are the reference checkpoint's: `w_gate` and
`w_noise` [d, E], `experts.{e}.fc1` / `.fc2`, and the buffers `mean` (0) and
`std` (1) of the reference's gate distribution, which nothing reads.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ziragroundingdino_torch.models.layers import Linear
from ziragroundingdino_torch.parallel.dist import all_reduce_sum


def cv_squared(x: torch.Tensor) -> torch.Tensor:
    """Squared coefficient of variation, population variance over squared
    mean (`moe.py:179-196`); 0 for a single value."""
    if x.shape[0] == 1:
        return torch.zeros((), dtype=torch.float32, device=x.device)
    x = x.float()
    return x.var(unbiased=False) / (x.mean() ** 2 + 1e-10)


def _normal_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


class Expert(nn.Module):
    """fc1 (U(+-1/sqrt(d)) weight, zero bias), ReLU, fc2 (zero)."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int,
                 compute_dtype: Optional[torch.dtype]):
        super().__init__()
        self.fc1 = Linear(input_size, hidden_size, compute_dtype=compute_dtype, init="kaiming")
        self.fc2 = Linear(hidden_size, output_size, compute_dtype=compute_dtype, init="zeros")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.relu(self.fc1(x)))


class MoE(nn.Module):
    def __init__(self, input_size: int, output_size: int, num_experts: int, hidden_size: int,
                 k: int = 1, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_experts = num_experts
        self.k = min(k, num_experts)
        self.compute_dtype = compute_dtype
        self.w_gate = nn.Parameter(torch.empty(input_size, num_experts))
        self.w_noise = nn.Parameter(torch.empty(input_size, num_experts))
        self.experts = nn.ModuleList(Expert(input_size, hidden_size, output_size, compute_dtype)
                                     for _ in range(num_experts))
        self.register_buffer("mean", torch.zeros(1))
        self.register_buffer("std", torch.ones(1))

    def init_weights(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.w_gate.zero_()
            self.w_noise.zero_()
            self.mean.zero_()
            self.std.fill_(1.0)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [N, d] -> (y [N, output_size] in the compute dtype, the f32
        balancing loss, at the weight 1 every caller of the JAX package's
        gives it). The gate is noisy where `generator` is given (its
        draws) or `noise` [N, E] is (those values); else it is the clean
        top k. Ties go to the lower expert index, as `jax.lax.top_k`'s."""
        e, k = self.num_experts, self.k
        cd = self.compute_dtype or x.dtype
        xf = x.float()
        clean = xf @ self.w_gate
        noisy = generator is not None or noise is not None
        if noisy:
            noise_std = nn.functional.softplus(xf @ self.w_noise) + 1e-2
            if noise is None:
                noise = torch.randn(clean.shape, generator=generator, device=x.device)
            logits = clean + noise.float() * noise_std
        else:
            logits = clean

        m = min(k + 1, e)
        order = torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :m]
        top_logits = torch.gather(logits, 1, order)
        topk_gates = torch.softmax(top_logits[:, :k], dim=-1)
        gates = torch.zeros_like(logits).scatter(1, order[:, :k], topk_gates)  # [N, E]

        # the balance loss is a function of the whole batch's sums, not a sum
        # over images: under data parallelism every rank takes it of the
        # global sums, where a gradient is taken (`parallel.dist.all_reduce_sum`)
        reduce = all_reduce_sum if torch.is_grad_enabled() else (lambda t: t)
        importance = reduce(gates.sum(0))
        if noisy and k < e:
            thr_in = top_logits[:, k:k + 1]
            thr_out = top_logits[:, k - 1:k]
            prob_in = _normal_cdf((clean - thr_in) / noise_std)
            prob_out = _normal_cdf((clean - thr_out) / noise_std)
            load = reduce(torch.where(logits > thr_in, prob_in, prob_out).sum(0))
        else:
            load = reduce((gates > 0).float().sum(0))
        loss = cv_squared(importance) + cv_squared(load)

        xc = x.to(cd)
        gc = gates.to(cd)
        out = sum(gc[:, i:i + 1] * expert(xc) for i, expert in enumerate(self.experts))
        return out, loss
