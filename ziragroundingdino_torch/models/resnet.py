"""ResNet-50/101 backbone with frozen BatchNorm, the port of the JAX
package's `models/resnet.py` (reference `backbone/backbone.py:33-71`:
torchvision's resnet50/101 with `FrozenBatchNorm2d`, the outputs of
layer2..4 for `return_interm_indices` (1, 2, 3)). NHWC throughout.

Module names are torchvision's under the reference's
`IntermediateLayerGetter` (`backbone.0.body.conv1`, `.bn1`,
`.layer1.0.conv1`, `.layer1.0.downsample.0` / `.1`, ...), so a
reference-format state dict loads by name.

The frozen BN keeps its four tensors (`weight`, `bias`, `running_mean`,
`running_var`) as parameters, not buffers as torchvision does: the JAX
package makes them parameters, and its `finetune` (every parameter
trains) trains them too. The port keeps JAX's behaviour. The fold
`w = weight * rsqrt(running_var + 1e-5)`, `b = bias - running_mean * w`
is taken at call time in the parameters' f32, then cast to the compute
dtype, as JAX does.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ziragroundingdino_torch.models.swin import interpolate_mask_nearest
from ziragroundingdino_torch.models.zira import conv_nhwc


class FrozenBatchNorm(nn.Module):
    """`FrozenBatchNorm2d` (torchvision; `backbone/backbone.py:48`) over the
    last axis of an NHWC tensor."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.running_mean = nn.Parameter(torch.empty(features))
        self.running_var = nn.Parameter(torch.empty(features))

    def init_weights(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight * torch.rsqrt(self.running_var + self.eps)
        b = self.bias - self.running_mean * w
        return x * w.to(x.dtype) + b.to(x.dtype)


class _Conv(nn.Conv2d):
    """A bias-free conv of an NHWC tensor in the compute dtype, padding
    k // 2; He-normal init (fan out, as torchvision's)."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int,
                 compute_dtype: Optional[torch.dtype]):
        super().__init__(cin, cout, kernel_size, stride=stride, padding=kernel_size // 2,
                         bias=False)
        self.compute_dtype = compute_dtype

    def reset_parameters(self) -> None:
        pass

    def init_weights(self, gen: torch.Generator) -> None:
        fan_out = self.out_channels * self.kernel_size[0] * self.kernel_size[1]
        with torch.no_grad():
            self.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype or x.dtype
        return conv_nhwc(x.to(cd), self.weight.to(cd), None, self.stride[0], self.padding[0])


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (the stride) -> 1x1 at 4x the planes, each with a frozen
    BN, and a downsample on the identity of a stage's first block."""

    def __init__(self, cin: int, planes: int, stride: int, downsample: bool,
                 compute_dtype: Optional[torch.dtype]):
        super().__init__()
        out = planes * 4
        self.conv1 = _Conv(cin, planes, 1, 1, compute_dtype)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = _Conv(planes, planes, 3, stride, compute_dtype)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = _Conv(planes, out, 1, 1, compute_dtype)
        self.bn3 = FrozenBatchNorm(out)
        self.downsample = (nn.Sequential(_Conv(cin, out, 1, stride, compute_dtype),
                                         FrozenBatchNorm(out)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class ResNet(nn.Module):
    """The body: a 7x7/2 stem, a 3x3/2 max pool (padding 1, -inf on both
    sides) and four stages of bottlenecks at 64/128/256/512 planes."""

    num_features = (256, 512, 1024, 2048)

    def __init__(self, depths: Tuple[int, ...], compute_dtype: Optional[torch.dtype]):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = _Conv(3, 64, 7, 2, compute_dtype)
        self.bn1 = FrozenBatchNorm(64)
        cin, planes = 64, 64
        for stage, depth in enumerate(depths):
            blocks = []
            for i in range(depth):
                stride = 2 if stage > 0 and i == 0 else 1
                blocks.append(Bottleneck(cin, planes, stride, i == 0, compute_dtype))
                cin = planes * 4
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
            planes *= 2
        self.num_stages = len(depths)


class ResNetBackbone(nn.Module):
    """`backbone.0` of a ResNet model: the body and the stages it returns.
    Input NHWC image + validity mask; output a list of (feature
    [B, h, w, C], mask [B, h, w]) for each index of `out_indices`."""

    def __init__(self, depths: Tuple[int, ...], out_indices: Tuple[int, ...],
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.body = ResNet(depths, compute_dtype)

    @property
    def out_channels(self) -> Tuple[int, ...]:
        return tuple(ResNet.num_features[i] for i in self.out_indices)

    def forward(self, pixels: torch.Tensor, mask: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        body = self.body
        x = F.relu(body.bn1(body.conv1(pixels)))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1).permute(0, 2, 3, 1)
        outs = []
        for stage in range(body.num_stages):
            x = getattr(body, f"layer{stage + 1}")(x)
            if stage in self.out_indices:
                outs.append((x, interpolate_mask_nearest(mask, x.shape[1], x.shape[2])))
        return outs
