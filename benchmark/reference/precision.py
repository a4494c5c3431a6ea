"""The controls' precisions: the reference's convolution and product
inputs rounded to the step below the one a configuration states. Under
autograd the gradient that flows back through a rounded input is rounded
too, as a backward computed in that precision rounds it."""

from __future__ import annotations

import torch

FP8_MAX = 448.0   # largest finite float8_e4m3fn


def fp8(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled float8 e4m3 rounding (the usual fp8 inference path)."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _Bf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return _Bf16.apply(x)
