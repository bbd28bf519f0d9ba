"""ZiRa dual-branch modules (arXiv 2403.01680), `RepZeroLinear` and
`RepZeroConv` from the JAX package's `models/zira.py` (reference
`groundingdino_dual_zero_rep_branch.py:62-135`).

Each holds a trainable branch (`weight`/`bias`, init 1e-8) scaled by a
learnable scalar (`scaling`, init 0.1) and a zero-init freeze branch
(`freeze_linear` / `freeze_conv`) that accumulates merged past-task deltas.
Serving (`forward`) runs the freeze branch only (`:94-95,126-127`).
Training (`forward_train`) runs ``freeze(x) + scaling * branch(x)`` and
returns the zero-interference loss ZIL = SmoothL1(branch_out, 0) +
SmoothL1(out, 0) beside it (`:87-95,119-127`). The merge (`rep_merge`)
belongs to the task lifecycle.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ziragroundingdino_torch.models.layers import Linear

ZERO_VALUE = 1e-8
LAN_SCALE = 0.1
VIS_SCALE = 0.1


def smooth_l1_to_zero(x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch's SmoothL1Loss(x, 0) with beta 1, in f32: the mean over every
    element, or with `mask` ([B, T] against x [B, T, D]) over the valid
    positions only (`_masked_mean`, `zira.py:35-51` of the JAX package: the
    reference's batch-1 ZIL over unpadded tokens)."""
    ax = x.float().abs()
    per = torch.where(ax < 1.0, 0.5 * ax * ax, ax - 0.5)
    if mask is None:
        return per.mean()
    m = mask.to(per.dtype)
    while m.dim() < per.dim():
        m = m[..., None]
    return (per * m).sum() / m.expand(per.shape).sum().clamp(min=1.0)


def conv_nhwc(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
              stride: int, padding: int) -> torch.Tensor:
    """Conv of an NHWC tensor with an OIHW weight; a 1x1/s1 conv is a matmul."""
    if weight.shape[2:] == (1, 1) and stride == 1 and padding == 0:
        return F.linear(x, weight[:, :, 0, 0], bias)
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


class Conv2d(nn.Conv2d):
    """nn.Conv2d applied to NHWC input in `compute_dtype`; init "xavier"
    (xavier-uniform weight, zero bias) or "zeros"."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int = 1,
                 compute_dtype: Optional[torch.dtype] = None, init: str = "xavier"):
        super().__init__(cin, cout, kernel_size, stride=stride, padding=kernel_size // 2)
        self.compute_dtype = compute_dtype
        self.init = init

    def reset_parameters(self) -> None:
        pass

    def init_weights(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            if self.init == "xavier":
                rf = self.kernel_size[0] * self.kernel_size[1]
                fan_in, fan_out = self.in_channels * rf, self.out_channels * rf
                bound = (6.0 / (fan_in + fan_out)) ** 0.5
                self.weight.uniform_(-bound, bound, generator=gen)
            elif self.init == "zeros":
                self.weight.zero_()
            else:
                raise ValueError(f"unknown init {self.init!r}")
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype or x.dtype
        return conv_nhwc(x.to(cd), self.weight.to(cd), self.bias.to(cd),
                         self.stride[0], self.padding[0])


class RepZeroLinear(nn.Module):
    def __init__(self, in_features: int, features: int, scale_init: float = LAN_SCALE,
                 zero_value: float = ZERO_VALUE, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.scale_init = scale_init
        self.zero_value = zero_value
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features))
        self.scaling = nn.Parameter(torch.empty(1))
        self.freeze_linear = Linear(in_features, features, compute_dtype=compute_dtype,
                                    init="zeros")

    def init_weights(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(self.zero_value)
            self.bias.fill_(self.zero_value)
            self.scaling.fill_(self.scale_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Eval forward: the freeze branch."""
        return self.freeze_linear(x)

    def forward_train(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Train forward: (freeze + scaling * branch, ZIL); `mask` [B, T]
        restricts the ZIL to valid tokens."""
        cd = self.freeze_linear.compute_dtype or x.dtype
        branch = self.scaling.to(cd) * F.linear(x.to(cd), self.weight.to(cd), self.bias.to(cd))
        out = branch + self.freeze_linear(x)
        return out, smooth_l1_to_zero(branch, mask) + smooth_l1_to_zero(out, mask)


class RepZeroConv(nn.Module):
    """Conv version (NHWC): kernel 1 (stride 1) or 3 (stride 2, pad 1), the
    two input-projection shapes (`:290-305`)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 1, stride: int = 1,
                 scale_init: float = VIS_SCALE, zero_value: float = ZERO_VALUE,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.scale_init = scale_init
        self.zero_value = zero_value
        self.weight = nn.Parameter(torch.empty(features, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(features))
        self.scaling = nn.Parameter(torch.empty(1))
        self.freeze_conv = Conv2d(in_channels, features, kernel_size, stride,
                                  compute_dtype=compute_dtype, init="zeros")

    def init_weights(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(self.zero_value)
            self.bias.fill_(self.zero_value)
            self.scaling.fill_(self.scale_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Eval forward: the freeze branch."""
        return self.freeze_conv(x)

    def forward_train(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Train forward: (freeze + scaling * branch, ZIL), the ZIL a plain
        mean over the whole (padded) map."""
        fc = self.freeze_conv
        cd = fc.compute_dtype or x.dtype
        branch = self.scaling.to(cd) * conv_nhwc(x.to(cd), self.weight.to(cd), self.bias.to(cd),
                                                 fc.stride[0], fc.padding[0])
        out = branch + fc(x)
        return out, smooth_l1_to_zero(branch) + smooth_l1_to_zero(out)
