"""RAFT-style local correlation: the plain version and the kernel's wrapper.

    out[b, y, x, dx·d + dy] = cast(scale · Σ_c f32(fm1[b, y, x, c])
                                          · f32(fm2[b, y+dy-r, x+dx-r, c]))

with d = 2r+1, scale = f32(1/√C), zeros outside the image, the sum taken in
float32 and rounded once to the input dtype. The channel order c = dx·d + dy
(horizontal shift slowest) is the reference quirk that
``rpnet_tpu/ops/correlation.py:27-50`` documents; the CRE's 1×1 conv weights
depend on it.

:func:`local_correlation_plain` is the shifted-products formula in PyTorch.
:func:`local_correlation` is the forward's wrapper: a CPU tensor goes to the
plain version; a CUDA tensor goes to the Hopper kernel
(``ops/csrc/local_corr.cu``, built by ``ops/kernels.py``) or raises.

The backward, in the gathered form of ``_corr_bwd_kernel``
(``rpnet_tpu/ops/pallas/correlation.py:776``), with δ = (dy−r, dx−r):

    dfm1[p, c] = scale · Σ_{dx,dy} g[p, dx·d+dy] · fm2[p+δ, c]
    dfm2[q, c] = scale · Σ_{dx,dy} g[q−δ, dx·d+dy] · fm1[q−δ, c]

summed in float32 and rounded once to the input dtype, has the same pair:
:func:`local_correlation_bwd_plain` and the wrapper
:func:`local_correlation_bwd` (``ops/csrc/local_corr_bwd.cu``).
:class:`LocalCorrelation` is the autograd Function over the two wrappers;
the CRE calls it through :func:`local_correlation_trainable`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

MAX_RADIUS = 5     # the kernel is instantiated for r = 1..5
CHANNEL_STEP = 16  # channels per staging step of the kernel (CC in the source)


def correlation_scale(C: int) -> float:
    """1/√C rounded to float32, as the JAX kernel applies it."""
    return float(np.float32(1.0 / np.sqrt(float(C))))


def local_correlation_plain(fm1: torch.Tensor, fm2: torch.Tensor, r: int) -> torch.Tensor:
    """Shifted-products local correlation. fm1, fm2: (B, H, W, C) → (B, H, W, d²)."""
    B, H, W, C = fm1.shape
    d = 2 * r + 1
    a = fm1.float()
    pad = F.pad(fm2.float(), (0, 0, r, r, r, r))   # zero rows/cols around the image
    out = torch.empty((B, H, W, d * d), dtype=torch.float32, device=fm1.device)
    for dx in range(d):        # horizontal shift — slow axis (reference quirk)
        for dy in range(d):    # vertical shift — fast axis
            out[..., dx * d + dy] = (a * pad[:, dy:dy + H, dx:dx + W, :]).sum(-1)
    return (out * correlation_scale(C)).to(fm1.dtype)


def _check_kernel_inputs(name: str, fm1: torch.Tensor, fm2: torch.Tensor,
                         r: int, max_batch: int) -> None:
    """Raise unless fm1, fm2 are what the Hopper kernels take."""
    if fm1.device.type != "cuda" or fm2.device != fm1.device:
        raise ValueError(f"{name}: tensors on {fm1.device} and "
                         f"{fm2.device}; the kernel needs both on one CUDA device")
    if fm1.dtype != fm2.dtype or fm1.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: dtypes {fm1.dtype}/{fm2.dtype}; "
                         "the kernel takes float32 or bfloat16, the same for both")
    if fm1.dim() != 4 or fm1.shape != fm2.shape:
        raise ValueError(f"{name}: shapes {tuple(fm1.shape)} and "
                         f"{tuple(fm2.shape)}; the kernel needs equal (B, H, W, C)")
    if not (fm1.is_contiguous() and fm2.is_contiguous()):
        raise ValueError(f"{name}: the kernel needs contiguous "
                         "channels-last (B, H, W, C) tensors")
    if not 1 <= r <= MAX_RADIUS:
        raise ValueError(f"{name}: radius {r} outside the kernel's "
                         f"1..{MAX_RADIUS}")
    B, H, W, C = fm1.shape
    if B > max_batch:
        raise ValueError(f"{name}: batch {B} exceeds the kernel's "
                         f"grid ({max_batch})")
    if C % CHANNEL_STEP or fm1.data_ptr() % 16 or fm2.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel reads {CHANNEL_STEP} "
                         "channels at a time in 16-byte loads; it needs C a "
                         f"multiple of {CHANNEL_STEP} (got {C}) and 16-byte "
                         "aligned tensors")


def local_correlation(fm1: torch.Tensor, fm2: torch.Tensor, r: int) -> torch.Tensor:
    """Local correlation; the Hopper kernel for CUDA tensors (see module doc)."""
    if fm1.device.type == "cpu" and fm2.device.type == "cpu":
        return local_correlation_plain(fm1, fm2, r)
    _check_kernel_inputs("local_correlation", fm1, fm2, r, max_batch=65535)
    from rpnet_tpu_torch.ops import kernels

    B, H, W, C = fm1.shape

    d = 2 * r + 1
    out = torch.empty((B, H, W, d * d), dtype=fm1.dtype, device=fm1.device)
    if out.numel() == 0:
        return out
    kernels.launch_local_corr(fm1, fm2, out, r, correlation_scale(C))
    local_correlation.launches += 1
    return out


local_correlation.launches = 0   # kernel launches (the plain path never counts)


def local_correlation_bwd_plain(g: torch.Tensor, fm1: torch.Tensor,
                                fm2: torch.Tensor, r: int):
    """Both input gradients in the gathered form (see module doc).

    g (B, H, W, d²) in quirk order; fm1, fm2 (B, H, W, C) → (dfm1, dfm2).
    """
    B, H, W, C = fm1.shape
    d = 2 * r + 1
    pad = (0, 0, r, r, r, r)                 # zero rows/cols around the image
    gf = g.float()
    gp = F.pad(gf, pad)
    fm1p = F.pad(fm1.float(), pad)
    fm2p = F.pad(fm2.float(), pad)
    dfm1 = torch.zeros((B, H, W, C), dtype=torch.float32, device=fm1.device)
    dfm2 = torch.zeros_like(dfm1)
    for dx in range(d):
        for dy in range(d):
            k = dx * d + dy
            # dfm1[p] += g[p, k] · fm2[p + δ]
            dfm1 += gf[..., k:k + 1] * fm2p[:, dy:dy + H, dx:dx + W]
            # dfm2[q] += g[q − δ, k] · fm1[q − δ]; q − δ = q + (r−dy, r−dx)
            ys, xs = 2 * r - dy, 2 * r - dx
            dfm2 += gp[:, ys:ys + H, xs:xs + W, k:k + 1] * fm1p[:, ys:ys + H, xs:xs + W]
    scale = correlation_scale(C)
    return (dfm1 * scale).to(fm1.dtype), (dfm2 * scale).to(fm2.dtype)


def local_correlation_bwd(g: torch.Tensor, fm1: torch.Tensor, fm2: torch.Tensor,
                          r: int):
    """The backward; the Hopper kernel for CUDA tensors (see module doc).

    The kernel reads g with its pixel stride: the CRE's ``torch.cat([corr,
    fm1])`` hands back g as a (B, H, W, d²) view of a (B, H, W, d²+C)
    gradient, which it takes as it is. A g whose pixels are not evenly
    strided is copied first.
    """
    if all(t.device.type == "cpu" for t in (g, fm1, fm2)):
        return local_correlation_bwd_plain(g, fm1, fm2, r)
    _check_kernel_inputs("local_correlation_bwd", fm1, fm2, r, max_batch=32767)
    B, H, W, C = fm1.shape
    d = 2 * r + 1
    if g.device != fm1.device or g.dtype != fm1.dtype or g.shape != (B, H, W, d * d):
        raise ValueError(f"local_correlation_bwd: g {tuple(g.shape)} {g.dtype} "
                         f"on {g.device}; the kernel needs ({B}, {H}, {W}, {d * d}) "
                         f"{fm1.dtype} on {fm1.device}")
    pitch = g.stride(2)
    if g.stride() != (H * W * pitch, W * pitch, pitch, 1) or pitch < d * d:
        g = g.contiguous()
        pitch = d * d
    from rpnet_tpu_torch.ops import kernels

    dfm1 = torch.empty_like(fm1)
    dfm2 = torch.empty_like(fm2)
    if dfm1.numel() == 0:
        return dfm1, dfm2
    kernels.launch_local_corr_bwd(g, pitch, fm1, fm2, dfm1, dfm2, r,
                                  correlation_scale(C))
    local_correlation_bwd.launches += 1
    return dfm1, dfm2


local_correlation_bwd.launches = 0


class LocalCorrelation(torch.autograd.Function):
    """Differentiable local correlation: :func:`local_correlation` forward,
    :func:`local_correlation_bwd` backward (the ``custom_vjp`` of
    ``pallas_correlation_trainable``). Episodes folded into the batch axis
    make one launch each way per call."""

    @staticmethod
    def forward(ctx, fm1, fm2, r: int):
        ctx.save_for_backward(fm1, fm2)
        ctx.r = r
        return local_correlation(fm1, fm2, r)

    @staticmethod
    def backward(ctx, g):
        fm1, fm2 = ctx.saved_tensors
        dfm1, dfm2 = local_correlation_bwd(g, fm1, fm2, ctx.r)
        return dfm1, dfm2, None


def local_correlation_trainable(fm1: torch.Tensor, fm2: torch.Tensor,
                                r: int) -> torch.Tensor:
    """:func:`local_correlation` with the kernel backward under autograd."""
    return LocalCorrelation.apply(fm1, fm2, r)
