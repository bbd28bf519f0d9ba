"""ZiRa dual-branch modules (arXiv 2403.01680), the port of the JAX package's
`models/zira.py` (reference `groundingdino_dual_zero_rep_branch.py:62-135`
and its variants).

Each holds a trainable branch (init 1e-8) beside a zero-init freeze branch
(`freeze_linear` / `freeze_conv`) that accumulates merged past-task deltas.
Serving (`forward`) runs the freeze branch only (`:94-95,126-127`).
Training (`forward_train`) runs both and returns the zero-interference loss
(ZIL) of the branch's output and of the sum beside it (`:87-95,119-127`).
After each task the lifecycle merges every branch into its freeze branch
(`rep_merge`, the reference's `__rep__`, `:97-103,129-135`), so that serving
sees what the task learned.

* `RepZeroLinear` / `RepZeroConv`: ``freeze(x) + scaling * branch(x)``, a
  learnable `scaling` (init 0.1); the multilayer variant's language branch
  is a `RepZeroLinear` with scaling 1.0 and an L1 ZIL;
* `RepZeroLoRA`: the low-rank language branch ``scaling * up(down(x))``
  beside a bias-free freeze linear (`adapter.py:227-259`);
* `RepZeroConvGN`: the multilayer variant's vision branch; in training the
  sum passes a zero-init GroupNorm (`freeze_gn`), scaling 1.0, L1 ZIL
  (`groundingdino_dual_zero_rep_multilayer_branch.py:70-113`);
* `RepZeroTransformerLayer`: a frozen attention block whose FFN linears are
  dual (`multilayer_branch.py:149-227`); no preset builds it;
* `ZeroConvBN`: the repconvbn variant's branch, conv + BatchNorm on batch
  statistics in training, folded into the freeze conv by `rep_merge_convbn`
  (`groundingdino_repconvbn.py:65-140`). It has no `scaling`, so `rep_merge`
  leaves it alone, as the JAX package's does.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ziragroundingdino_torch.models.layers import LayerNorm, Linear, MultiHeadAttention

ZERO_VALUE = 1e-8
LAN_SCALE = 0.1
VIS_SCALE = 0.1
BN_EPS = 1e-5
GN_GROUPS = 32


def _masked_mean(per: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The mean over every element, or with `mask` ([B, T] against per
    [B, T, D]) over the valid positions only (`_masked_mean`, `zira.py:35-51`
    of the JAX package: the reference's batch-1 ZIL over unpadded tokens)."""
    if mask is None:
        return per.mean()
    m = mask.to(per.dtype)
    while m.dim() < per.dim():
        m = m[..., None]
    return (per * m).sum() / m.expand(per.shape).sum().clamp(min=1.0)


def smooth_l1_to_zero(x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch's SmoothL1Loss(x, 0) with beta 1, in f32, masked as `_masked_mean`."""
    ax = x.float().abs()
    return _masked_mean(torch.where(ax < 1.0, 0.5 * ax * ax, ax - 0.5), mask)


def l1_to_zero(x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch's L1Loss(x, 0) in f32, masked as `_masked_mean`: the multilayer
    variant's ZIL (`multilayer_branch.py:89`)."""
    return _masked_mean(x.float().abs(), mask)


def zil_fn(kind: str) -> Callable:
    return {"smooth_l1": smooth_l1_to_zero, "l1": l1_to_zero}[kind]


def conv_nhwc(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
              stride: int, padding: int) -> torch.Tensor:
    """Conv of an NHWC tensor with an OIHW weight; a 1x1/s1 conv is a matmul."""
    if weight.shape[2:] == (1, 1) and stride == 1 and padding == 0:
        return F.linear(x, weight[:, :, 0, 0], bias)
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


class Conv2d(nn.Conv2d):
    """nn.Conv2d applied to NHWC input in `compute_dtype`; init "xavier"
    (xavier-uniform weight, zero bias), "zeros", or a float that fills
    weight and bias."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int = 1,
                 compute_dtype: Optional[torch.dtype] = None,
                 init: Union[str, float] = "xavier"):
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
                self.bias.zero_()
            elif self.init == "zeros":
                self.weight.zero_()
                self.bias.zero_()
            elif isinstance(self.init, float):
                self.weight.fill_(self.init)
                self.bias.fill_(self.init)
            else:
                raise ValueError(f"unknown init {self.init!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype or x.dtype
        return conv_nhwc(x.to(cd), self.weight.to(cd), self.bias.to(cd),
                         self.stride[0], self.padding[0])


class RepZeroLinear(nn.Module):
    def __init__(self, in_features: int, features: int, scale_init: float = LAN_SCALE,
                 zero_value: float = ZERO_VALUE, compute_dtype: Optional[torch.dtype] = None,
                 zil: str = "smooth_l1"):
        super().__init__()
        self.scale_init = scale_init
        self.zero_value = zero_value
        self.zil = zil
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
        loss = zil_fn(self.zil)
        return out, loss(branch, mask) + loss(out, mask)


class RepZeroLoRA(nn.Module):
    """The low-rank language branch (`adapter.py:227-259`): ``scaling *
    up(down(x))``, `down` and `up` bias-free and init 1e-8, beside a
    bias-free zero-init freeze linear."""

    def __init__(self, in_features: int, features: int, down_dim: Optional[int] = None,
                 scale_init: float = LAN_SCALE, zero_value: float = ZERO_VALUE,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        dd = down_dim or in_features // 4
        self.scale_init = scale_init
        self.down = Linear(in_features, dd, bias=False, compute_dtype=compute_dtype,
                           init=zero_value)
        self.up = Linear(dd, features, bias=False, compute_dtype=compute_dtype, init=zero_value)
        self.scaling = nn.Parameter(torch.empty(1))
        self.freeze_linear = Linear(in_features, features, bias=False,
                                    compute_dtype=compute_dtype, init="zeros")

    def init_weights(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.scaling.fill_(self.scale_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Eval forward: the freeze branch."""
        return self.freeze_linear(x)

    def forward_train(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        cd = self.freeze_linear.compute_dtype or x.dtype
        branch = self.scaling.to(cd) * self.up(self.down(x))
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

    def _branch(self, x: torch.Tensor) -> torch.Tensor:
        """The trainable conv (weight and bias) in the compute dtype."""
        fc = self.freeze_conv
        cd = fc.compute_dtype or x.dtype
        return conv_nhwc(x.to(cd), self.weight.to(cd), self.bias.to(cd), fc.stride[0],
                         fc.padding[0])

    def forward_train(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Train forward: (freeze + scaling * branch, ZIL), the ZIL a plain
        mean over the whole (padded) map."""
        branch = self.scaling.to(self.freeze_conv.compute_dtype or x.dtype) * self._branch(x)
        out = branch + self.freeze_conv(x)
        return out, smooth_l1_to_zero(branch) + smooth_l1_to_zero(out)


class _ZeroGroupNorm(nn.GroupNorm):
    """GroupNorm(32) whose affine weight and bias start at `zero_value`."""

    def __init__(self, features: int, zero_value: float):
        super().__init__(GN_GROUPS, features, eps=1e-5)
        self.zero_value = zero_value

    def init_weights(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(self.zero_value)
            self.bias.fill_(self.zero_value)


class RepZeroConvGN(RepZeroConv):
    """The multilayer variant's vision branch: in training ``gn(freeze(x) +
    branch(x) * scaling)``, the zero-init GroupNorm `freeze_gn` in f32 over
    the sum, with an L1 ZIL; scaling init 1.0. Eval runs the freeze conv
    alone, without the norm."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 1, stride: int = 1,
                 zero_value: float = ZERO_VALUE, compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_channels, features, kernel_size, stride, scale_init=1.0,
                         zero_value=zero_value, compute_dtype=compute_dtype)
        self.freeze_gn = _ZeroGroupNorm(features, zero_value)

    def forward_train(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cd = self.freeze_conv.compute_dtype or x.dtype
        branch = self._branch(x) * self.scaling.to(cd)
        s = (branch + self.freeze_conv(x)).float().permute(0, 3, 1, 2)
        gn = self.freeze_gn
        out = F.group_norm(s, gn.num_groups, gn.weight, gn.bias, gn.eps).permute(0, 2, 3, 1)
        out = out.to(cd)
        return out, l1_to_zero(branch) + l1_to_zero(out)


class RepZeroTransformerLayer(nn.Module):
    """A frozen self-attention block whose FFN linears are dual: each
    ``freeze_linear{i}(x) + free_linear{i}(x)`` in training, the freeze one
    alone in eval (`multilayer_branch.py:149-227`); the merge adds the free
    linear into the freeze one 1:1. ZIL: L1 of both free outputs and of the
    block's output."""

    def __init__(self, embed_dim: int, nhead: int = 8, down_dim: int = 2048,
                 zero_value: float = ZERO_VALUE, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        cd = compute_dtype
        self.freeze_self_attn = MultiHeadAttention(embed_dim, nhead, compute_dtype=cd)
        self.freeze_norm1 = LayerNorm(embed_dim, eps=1e-5)
        self.freeze_linear1 = Linear(embed_dim, down_dim, compute_dtype=cd, init="zeros")
        self.free_linear1 = Linear(embed_dim, down_dim, compute_dtype=cd, init=zero_value)
        self.freeze_linear2 = Linear(down_dim, embed_dim, compute_dtype=cd, init="zeros")
        self.free_linear2 = Linear(down_dim, embed_dim, compute_dtype=cd, init=zero_value)
        self.freeze_norm2 = LayerNorm(embed_dim, eps=1e-5)
        self.compute_dtype = compute_dtype

    def _run(self, x: torch.Tensor, train: bool):
        cd = self.compute_dtype or x.dtype
        x = self.freeze_norm1(x + self.freeze_self_attn(x, x, x)).to(cd)
        y = self.freeze_linear1(x)
        b1 = self.free_linear1(x) if train else None
        y = F.relu(y + b1 if train else y)
        y2 = self.freeze_linear2(y)
        b2 = self.free_linear2(y) if train else None
        out = self.freeze_norm2(y2 + b2 if train else y2).to(cd)
        return out, b1, b2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Eval forward: the freeze linears only."""
        return self._run(x, False)[0]

    def forward_train(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        out, b1, b2 = self._run(x, True)
        return out, l1_to_zero(b1) + l1_to_zero(b2) + l1_to_zero(out)


class _BatchNorm(nn.Module):
    """The ZeroConvBN branch's BatchNorm parameters under the reference's
    `nn.BatchNorm2d` names: affine `weight` and `bias`, and the
    `running_mean` / `running_var` buffers (JAX's `batch_stats`), all
    starting at `zero_value`. (The reference's `num_batches_tracked` is not
    kept: nothing reads it.)"""

    def __init__(self, features: int, zero_value: float):
        super().__init__()
        self.zero_value = zero_value
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("running_mean", torch.empty(features))
        self.register_buffer("running_var", torch.empty(features))

    def init_weights(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            for t in (self.weight, self.bias, self.running_mean, self.running_var):
                t.fill_(self.zero_value)


class _ConvBN(nn.Module):
    def __init__(self, in_channels: int, features: int, kernel_size: int, stride: int,
                 zero_value: float, compute_dtype: Optional[torch.dtype]):
        super().__init__()
        self.conv = Conv2d(in_channels, features, kernel_size, stride,
                           compute_dtype=compute_dtype, init=zero_value)
        self.bn = _BatchNorm(features, zero_value)


class ZeroConvBN(nn.Module):
    """The repconvbn variant's vision branch: ``freeze(x) + bn(conv(x))``
    in training, BatchNorm on the batch's statistics (biased variance, f32),
    the freeze conv alone in eval. `forward_train(update_stats=True)` also
    moves the running statistics (momentum 0.9), as the JAX module does
    only when `batch_stats` is mutable; the train step does not ask for it,
    so they stay as loaded, as in the JAX package's train step."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 1, stride: int = 1,
                 zero_value: float = ZERO_VALUE, momentum: float = 0.9,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.zero_value = zero_value
        self.momentum = momentum
        self.freeze_conv = Conv2d(in_channels, features, kernel_size, stride,
                                  compute_dtype=compute_dtype, init="zeros")
        self.branch = _ConvBN(in_channels, features, kernel_size, stride, zero_value,
                              compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Eval forward: the freeze branch."""
        return self.freeze_conv(x)

    def forward_train(self, x: torch.Tensor, update_stats: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        cd = self.freeze_conv.compute_dtype or x.dtype
        bn = self.branch.bn
        y = self.branch.conv(x).float()
        mean = y.mean(dim=(0, 1, 2))
        var = y.var(dim=(0, 1, 2), unbiased=False)
        if update_stats:
            with torch.no_grad():
                m = self.momentum
                bn.running_mean.mul_(m).add_((1 - m) * mean)
                bn.running_var.mul_(m).add_((1 - m) * var)
        branch = ((y - mean) * torch.rsqrt(var + BN_EPS) * bn.weight + bn.bias).to(cd)
        out = branch + self.freeze_conv(x)
        return out, smooth_l1_to_zero(branch) + smooth_l1_to_zero(out)


# the modules whose merge is ``freeze += scaling * branch`` (JAX's `is_rep_module`)
REP_MODULES = (RepZeroLinear, RepZeroConv)  # RepZeroConvGN is a RepZeroConv


def is_rep_module(module: nn.Module) -> bool:
    """A dual module with a freeze weight, a branch weight and a scaling
    (`zira.py:409-415` of the JAX package): what `rep_merge` folds with its
    scaling. RepZeroLoRA and RepZeroTransformerLayer merge their own way,
    ZeroConvBN not at all."""
    return isinstance(module, REP_MODULES)


def default_scale_reset(name: str, module: nn.Module) -> float:
    """The scaling `rep_merge` restores by default, each module's own init:
    1.0 for the multilayer variant's GN conv modules and its
    `rep_language_adapter` (`multilayer_branch.py:107-146`), 0.1 for the
    dual variant's branches (`:97-103,129-135`)."""
    if isinstance(module, RepZeroConvGN) or "rep_language_adapter" in name:
        return 1.0
    return LAN_SCALE  # == VIS_SCALE


def scale_reset_for_cfg(cfg) -> Callable[[str, nn.Module], float]:
    """The scaling reset that honours the config's inits (`zira_lan_scale`
    for the language branch `rep_linear_adapter`, `zira_vis_scale` for the
    vision branches; 1.0 for the multilayer variant's, whose inits are
    fixed), as the reference's `__rep__` re-creates each module's scaling at
    its own init."""

    def reset(name: str, module: nn.Module) -> float:
        if isinstance(module, RepZeroConvGN) or "rep_language_adapter" in name:
            return 1.0
        return cfg.zira_lan_scale if "rep_linear_adapter" in name else cfg.zira_vis_scale

    return reset


@torch.no_grad()
def rep_merge(model: nn.Module, zero_value: float = ZERO_VALUE,
              scale_reset: Callable[[str, nn.Module], float] = default_scale_reset) -> List[str]:
    """`__rep__` of every ZiRa module of `model` that has one, in place, in
    the parameters' f32, as the JAX package's `rep_merge`:
      * RepZeroLinear / RepZeroConv / RepZeroConvGN: ``freeze += scaling *
        branch`` (weight and bias), the branch set back to `zero_value`;
      * RepZeroLoRA: ``freeze += scaling * up @ down``, both factors set back
        to `zero_value` (`adapter.py:255-259`);
      * RepZeroTransformerLayer: ``freeze_linear{i} += free_linear{i}`` 1:1,
        the free linears set back to `zero_value`;
    and each `scaling` to `scale_reset(name, module)`. ZeroConvBN has no
    scaling and is not merged here (`rep_merge_convbn` folds it). Returns
    the merged modules' names. An optimizer built before the merge holds
    moments of the old branches: build a new one, as each task does."""
    merged = []
    for name, mod in model.named_modules():
        if isinstance(mod, RepZeroLoRA):
            mod.freeze_linear.weight += mod.scaling * (mod.up.weight @ mod.down.weight)
            mod.down.weight.fill_(zero_value)
            mod.up.weight.fill_(zero_value)
        elif is_rep_module(mod):
            freeze = mod.freeze_linear if isinstance(mod, RepZeroLinear) else mod.freeze_conv
            freeze.weight += mod.scaling * mod.weight
            freeze.bias += mod.scaling * mod.bias
            mod.weight.fill_(zero_value)
            mod.bias.fill_(zero_value)
        elif isinstance(mod, RepZeroTransformerLayer):
            for frozen, free in ((mod.freeze_linear1, mod.free_linear1),
                                 (mod.freeze_linear2, mod.free_linear2)):
                for part in ("weight", "bias"):
                    getattr(frozen, part).add_(getattr(free, part))
                    getattr(free, part).fill_(zero_value)
            merged.append(name)
            continue
        else:
            continue
        mod.scaling.fill_(scale_reset(name, mod))
        merged.append(name)
    return merged


@torch.no_grad()
def rep_merge_convbn(model: nn.Module, zero_value: float = ZERO_VALUE,
                     eps: float = BN_EPS) -> List[str]:
    """`__rep__` of every ZeroConvBN (`groundingdino_repconvbn.py:107-140`),
    in place: the BatchNorm folded into the branch conv with the running
    statistics and added into the freeze conv, ``freeze.weight += w * t``,
    ``freeze.bias += bn.bias + (b - mean) * t``, t = bn.weight / sqrt(var +
    eps) (the additive fold, PARITY.md); then the branch conv, the BN's
    affine parameters and its statistics set back to `zero_value`. Returns
    the merged modules' names."""
    merged = []
    for name, mod in model.named_modules():
        if not isinstance(mod, ZeroConvBN):
            continue
        conv, bn, freeze = mod.branch.conv, mod.branch.bn, mod.freeze_conv
        t = bn.weight / torch.sqrt(bn.running_var + eps)
        freeze.weight += conv.weight * t[:, None, None, None]
        freeze.bias += bn.bias + (conv.bias - bn.running_mean) * t
        for p in (conv.weight, conv.bias, bn.weight, bn.bias, bn.running_mean, bn.running_var):
            p.fill_(zero_value)
        merged.append(name)
    return merged
