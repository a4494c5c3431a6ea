"""The arithmetic of ``ops/csrc/local_corr.cu``'s f32 instance, modelled in
torch on the CPU.

The kernel computes the forward local correlation as band products on the
tensor cores. A block owns 4 query rows and a 32-query strip of one image,
as two 16-query sub-strips. For each source row s and sub-strip j it forms

    D[64 x 32] = A[64 x C] · B[32 x C]^T,

A's rows the sub-strip's 16 queries of all 4 query rows (row 16q + m), B's
rows the 32 source columns x0 + 16j - r + n of row s, zero outside the
image and past C. Element (16q + m, n) is the product at dy = s - (y0+q) + r,
dx = n - m; the epilogue keeps those with both in [0, d). Channels are
summed in groups of 256 (what a block holds of fm1 at once): each group's
D is scaled and added into the output tile in f32. The products are
3xTF32: each operand split into a TF32 big part (low 13 bits masked) and
the rest, small·big + big·small + big·big.

This file builds those products block by block with the kernel's tiling,
extracts the band as the kernel does and holds the result against
``local_correlation_plain`` (the card's yardstick) at the card's atol, and
at one small shape against the TPU kernel the f32 instance replaces
(``_corr_kernel`` through ``local_correlation_pallas``, interpret mode).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpnet_tpu.ops.pallas.correlation import local_correlation_pallas
from rpnet_tpu_torch.ops.correlation import (correlation_scale,
                                             local_correlation_plain)

QR = 4       # query rows a block (one per warp of a warpgroup)
SUB = 16     # queries a sub-strip (one consumer warpgroup)
NSUB = 2     # sub-strips a block
NB = 32      # source columns a product (16 + 2r <= 32)
CK = 32      # channels a chunk (one 128-byte TMA box of f32)
GROUP = 8    # chunks a group: the fm1 a block holds at once


def tf32(x: torch.Tensor) -> torch.Tensor:
    """What a TF32 tensor core reads of an f32 value: the low 13 bits masked."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def three_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's three TF32 passes, summed in f32."""
    ab, bb = tf32(a), tf32(b)
    return (torch.matmul(tf32(a - ab), bb) + torch.matmul(ab, tf32(b - bb))
            + torch.matmul(ab, bb))


def band_fwd(fm1: torch.Tensor, fm2: torch.Tensor, r: int,
             product=torch.matmul) -> torch.Tensor:
    """The forward (B, H, W, d²) as the kernel's tiles compute it."""
    B, H, W, C = fm1.shape
    d = 2 * r + 1
    ny, nx = -(-H // QR), -(-W // (SUB * NSUB))
    nj = nx * NSUB                                   # sub-strips across the image
    cp = -(-C // CK) * CK                            # boxes past C arrive zero-filled
    groups = [(c, min(c + GROUP * CK, cp)) for c in range(0, cp, GROUP * CK)]
    # fm1 in query tiles; fm2 with r zero rows and columns before the image
    dt = fm1.dtype
    a = torch.zeros((B, ny * QR, nj * SUB, cp), dtype=dt)
    a[:, :H, :W, :C] = fm1
    a = a.view(B, ny, QR, nj, SUB, cp).permute(0, 1, 3, 2, 4, 5).reshape(B, ny, nj, QR * SUB, cp)
    src = torch.zeros((B, ny * QR + 2 * r, nj * SUB + NB, cp), dtype=dt)
    src[:, r:r + H, r:r + W, :C] = fm2
    cols = torch.arange(nj)[:, None] * SUB + torch.arange(NB)[None, :]   # (nj, NB)
    out = torch.zeros((B, ny, QR, nj, SUB, d, d), dtype=dt)   # [..., m, dx, dy]
    m = torch.arange(SUB)[:, None]
    n = m + torch.arange(d)[None, :]                  # column of (m, dx)
    for i in range(QR + 2 * r):                       # source row s = y0 - r + i
        rows = torch.arange(ny) * QR + i
        bt = src[:, rows][:, :, cols]                 # (B, ny, nj, NB, cp)
        tile = torch.zeros((B, ny, nj, QR * SUB, NB), dtype=dt)
        for c0, c1 in groups:                         # each group scaled, then added
            tile = tile + product(a[..., c0:c1], bt[..., c0:c1].transpose(-1, -2)) \
                * correlation_scale(C)
        for q in range(QR):
            dy = i - q
            if 0 <= dy < d:
                rowq = tile[:, :, :, q * SUB:(q + 1) * SUB]             # (B, ny, nj, SUB, NB)
                out[:, :, q, :, :, :, dy] = rowq[..., m, n]
    return out.reshape(B, ny * QR, nj * SUB, d * d)[:, :H, :W]


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randn(*shape).astype(np.float32)) for _ in range(2))


@pytest.mark.parametrize("r", [1, 2, 5])
@pytest.mark.parametrize("C", [16, 48, 320])
def test_band_tiles_match_plain(C, r):
    """3xTF32 band tiles (4 rows x 32 queries a block, W = 40 past one strip,
    H = 6 ragged, C past one 256-channel group at 320) within the card's
    atol 1e-4 of the plain forward."""
    fm1, fm2 = _inputs((2, 6, 40, C), seed=C + r)
    ref = local_correlation_plain(fm1, fm2, r)
    out = band_fwd(fm1, fm2, r, product=three_tf32)
    assert out.shape == ref.shape
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)


def test_band_tiles_match_tpu_kernel():
    """f32 products through the band tiles against the TPU kernel the f32
    instance replaces (``_corr_kernel``, interpret mode): atol 1e-5, sums in
    another order."""
    fm1, fm2 = _inputs((1, 5, 36, 48), seed=11)
    ref = np.asarray(local_correlation_pallas(jnp.asarray(fm1.numpy()), jnp.asarray(fm2.numpy()),
                                              2, interpret=True))
    out = band_fwd(fm1, fm2, 2)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_three_tf32_error_at_full_width():
    """At C=256, r=5 (the training shape's channels and radius) the 3xTF32
    tiles stay within the card's atol 1e-4 of the forward in f64, while one
    TF32 pass does not."""
    fm1, fm2 = _inputs((1, 8, 20, 256), seed=7)
    exact = band_fwd(fm1.double(), fm2.double(), 5)
    emulated = band_fwd(fm1, fm2, 5, product=three_tf32)
    one_pass = band_fwd(fm1, fm2, 5, product=lambda a, b: torch.matmul(tf32(a), tf32(b)))
    err3 = (emulated.double() - exact).abs().max().item()
    err1 = (one_pass.double() - exact).abs().max().item()
    assert err3 < 1e-4, err3
    assert err1 > 1e-4, err1
