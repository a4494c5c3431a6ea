"""RAFT-style local correlation: the plain version and the kernel's wrapper.

    out[b, y, x, dx·d + dy] = cast(scale · Σ_c f32(fm1[b, y, x, c])
                                          · f32(fm2[b, y+dy-r, x+dx-r, c]))

with d = 2r+1, scale = f32(1/√C), zeros outside the image, the sum taken in
float32 and rounded once to the input dtype. The channel order c = dx·d + dy
(horizontal shift slowest) is the reference quirk that
``rpnet_tpu/ops/correlation.py:27-50`` documents; the CRE's 1×1 conv weights
depend on it.

:func:`local_correlation_plain` is the shifted-products formula in PyTorch.
:func:`local_correlation` is what the model calls: a CPU tensor goes to the
plain version; a CUDA tensor goes to the Hopper kernel
(``ops/csrc/local_corr.cu``, built by ``ops/kernels.py``) or raises.
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


def local_correlation(fm1: torch.Tensor, fm2: torch.Tensor, r: int) -> torch.Tensor:
    """Local correlation; the Hopper kernel for CUDA tensors (see module doc)."""
    if fm1.device.type == "cpu" and fm2.device.type == "cpu":
        return local_correlation_plain(fm1, fm2, r)
    if fm1.device.type != "cuda" or fm2.device != fm1.device:
        raise ValueError(f"local_correlation: tensors on {fm1.device} and "
                         f"{fm2.device}; the kernel needs both on one CUDA device")
    if fm1.dtype != fm2.dtype or fm1.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"local_correlation: dtypes {fm1.dtype}/{fm2.dtype}; "
                         "the kernel takes float32 or bfloat16, the same for both")
    if fm1.dim() != 4 or fm1.shape != fm2.shape:
        raise ValueError(f"local_correlation: shapes {tuple(fm1.shape)} and "
                         f"{tuple(fm2.shape)}; the kernel needs equal (B, H, W, C)")
    if not (fm1.is_contiguous() and fm2.is_contiguous()):
        raise ValueError("local_correlation: the kernel needs contiguous "
                         "channels-last (B, H, W, C) tensors")
    if not 1 <= r <= MAX_RADIUS:
        raise ValueError(f"local_correlation: radius {r} outside the kernel's "
                         f"1..{MAX_RADIUS}")
    B, H, W, C = fm1.shape
    if B > 65535:
        raise ValueError(f"local_correlation: batch {B} exceeds the kernel's "
                         "grid (65535)")
    if C % CHANNEL_STEP or fm1.data_ptr() % 16 or fm2.data_ptr() % 16:
        raise ValueError(f"local_correlation: the kernel reads {CHANNEL_STEP} "
                         "channels at a time in 16-byte loads; it needs C a "
                         f"multiple of {CHANNEL_STEP} (got {C}) and 16-byte "
                         "aligned tensors")
    from rpnet_tpu_torch.ops import kernels

    d = 2 * r + 1
    out = torch.empty((B, H, W, d * d), dtype=fm1.dtype, device=fm1.device)
    if out.numel() == 0:
        return out
    kernels.launch_local_corr(fm1, fm2, out, r, correlation_scale(C))
    local_correlation.launches += 1
    return out


local_correlation.launches = 0   # kernel launches (the plain path never counts)
