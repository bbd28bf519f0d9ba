"""Where the reference computes, and the control's lower precision.

The reference computes every operation in float32, with TF32 off. The
configurations state bfloat16 for the matrix products that the port runs in
its compute dtype; `operand(t, low=True)` marks such an operand. In the
control (`MODE["low"] = "fp8"`) those operands, and only those, are rounded
to float8 e4m3 with one scale per tensor (the nearest precision below
bfloat16) before the product, which still accumulates in float32.
"""

from __future__ import annotations

import contextlib

import torch

MODE = {"low": "f32"}  # "f32": the reference; "fp8": the control
E4M3_MAX = 448.0


class _FP8(torch.autograd.Function):
    """The rounding in the forward; the gradient passes through unrounded
    (the backward's products take the rounded operands the forward saved)."""

    @staticmethod
    def forward(ctx, t):
        scale = t.abs().amax().clamp(min=1e-30) / E4M3_MAX
        return (t / scale).to(torch.float8_e4m3fn).float() * scale

    @staticmethod
    def backward(ctx, g):
        return g


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one per-tensor scale, back in float32."""
    return _FP8.apply(t.float())


def operand(t: torch.Tensor, low: bool) -> torch.Tensor:
    """A matrix product's operand: float32, or in the control fp8 where the
    configuration computes it in bfloat16 (`low`)."""
    if low and MODE["low"] == "fp8":
        return fp8_round(t)
    return t.float()


@contextlib.contextmanager
def control():
    """Run the reference as the control (fp8 where the port uses bf16)."""
    old = MODE["low"]
    MODE["low"] = "fp8"
    try:
        yield
    finally:
        MODE["low"] = old


def strict_f32() -> None:
    """No TF32 anywhere: a float32 product on the card is float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
