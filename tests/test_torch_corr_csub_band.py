"""The arithmetic of ``ops/csrc/local_corr_csub.cu``'s bf16 instance,
modelled in torch on the CPU.

The kernel computes the local correlation on the C-strided layout
(B, H, C, W) as band products on the tensor cores. A block owns 4 query rows
and a 32-query strip of one image, as two 16-query sub-strips. fm2 is
staged per source row from column x0 - 16, 64 columns wide; sub-strip j's
product window is the 32 staged columns from 8 + 16j on. For each source row
s and sub-strip j it forms

    D[64 x 32] = A[64 x C] · B[32 x C]^T,

A's rows the sub-strip's 16 queries of all 4 query rows (row 16q + m), B's
rows the window's columns x0 + 16j - 8 + n of row s, zero outside the image
and past C (channels in chunks of 64). Element (16q + m, n) is the product
at dy = s - (y0+q) + r, dx = n - m - (8 - r); the epilogue keeps those with
both in [0, d), scales them and rounds once to the input dtype, in the
quirk order dx·d + dy. bf16 products are exact in the f32 accumulators.

This file builds those products block by block with the kernel's tiling,
extracts the band as the kernel does and holds the result against
``local_correlation_csub_plain`` (the card's yardstick), and at one small
shape against the TPU kernel it replaces (``_corr_csub_kernel`` through
``local_correlation_pallas_csub``, interpret mode).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpnet_tpu.ops.pallas.correlation import local_correlation_pallas_csub
from rpnet_tpu_torch.ops.correlation import (_corr_sums, correlation_scale,
                                             local_correlation_csub_plain)

QR = 4       # query rows a block (one per warp of a warpgroup)
SUB = 16     # queries a sub-strip (one consumer warpgroup, one 32-byte swizzle atom)
NSUB = 2     # sub-strips a block
TXW = SUB * NSUB
NB = 32      # window columns a product
LEAD = 16    # fm2 is staged from column x0 - LEAD
WIN = 8      # sub-strip 0's window starts WIN staged columns in
SCOLS = 64   # staged columns (one 128-byte swizzle atom of bf16)
CK = 64      # channels a chunk


def band_csub(fm1t: torch.Tensor, fm2t: torch.Tensor, r: int) -> torch.Tensor:
    """(B, H, C, W) inputs → the (B, H, W, d²) output as the kernel's tiles
    compute it: f32 products of the input values, f32 sums over the chunks,
    one rounding to the input dtype."""
    B, H, C, W = fm1t.shape
    d = 2 * r + 1
    ny, nx = -(-H // QR), -(-W // TXW)
    nj = nx * NSUB                                   # sub-strips across the image
    cp = -(-C // CK) * CK                            # boxes past C arrive zero-filled
    # A: (B, ny, nj, 64, cp), row 16q + m = fm1 at (y0 + q, x0 + 16j + m)
    a = torch.zeros((B, ny * QR, cp, nj * SUB))
    a[:, :H, :C, :W] = fm1t.float()
    a = a.view(B, ny, QR, cp, nj, SUB).permute(0, 1, 4, 2, 5, 3).reshape(B, ny, nj, QR * SUB, cp)
    # fm2 with r zero rows above the image; column x of the image at LEAD + x
    src = torch.zeros((B, ny * QR + 2 * r, cp, LEAD + nx * TXW + SCOLS))
    src[:, r:r + H, :C, LEAD:LEAD + W] = fm2t.float()
    # block bx stages src columns bx·32 .. bx·32 + 63 (x0 - 16 ..); sub-strip
    # J = 2·bx + j reads window columns WIN + 16j + n of that stage
    J = torch.arange(nj)
    stage0 = (J // NSUB) * TXW
    assert (WIN + (J % NSUB) * SUB + NB <= SCOLS).all()   # the window lies in the stage
    cols = (stage0 + WIN + (J % NSUB) * SUB)[:, None] + torch.arange(NB)[None, :]   # (nj, NB)
    out = torch.zeros((B, ny, QR, nj, SUB, d, d))    # [..., m, dx, dy]
    m = torch.arange(SUB)[:, None]
    n = m + (WIN - r) + torch.arange(d)[None, :]     # window column of (m, dx)
    for i in range(QR + 2 * r):                      # source row s = y0 - r + i
        rows = torch.arange(ny) * QR + i
        bt = src[:, rows][..., cols].permute(0, 1, 3, 4, 2)   # (B, ny, nj, NB, cp)
        tile = torch.zeros((B, ny, nj, QR * SUB, NB))
        for c0 in range(0, cp, CK):                  # chunks summed in f32
            tile = tile + torch.matmul(a[..., c0:c0 + CK],
                                       bt[..., c0:c0 + CK].transpose(-1, -2))
        tile = tile * correlation_scale(C)
        for q in range(QR):
            dy = i - q
            if 0 <= dy < d:
                rowq = tile[:, :, :, q * SUB:(q + 1) * SUB]     # (B, ny, nj, SUB, NB)
                out[:, :, q, :, :, :, dy] = rowq[..., m, n]
    out = out.reshape(B, ny * QR, nj * SUB, d * d)[:, :H, :W]
    return out.to(fm1t.dtype)


def _inputs(shape, seed, dtype):
    """(B, H, C, W) inputs of ``dtype`` from a seed."""
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)
                 for _ in range(2))


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("r", [1, 2, 5])
@pytest.mark.parametrize("C", [16, 48, 320])
def test_csub_tiles_match_plain(C, r, dtype):
    """Band tiles (4 rows x 32 queries a block, W = 44 past one block with
    W % 8 = 4, H = 6 ragged, C = 16 and 48 inside one 64-channel chunk, 320
    over five) against the plain version: f32 within atol 1e-4; bf16 within
    one bf16 ulp of the f32 sum (1e-5 near zero, where f32 sums in another
    order part by more than their ulp)."""
    fm1t, fm2t = _inputs((2, 6, C, 44), seed=C + r, dtype=dtype)
    ref = local_correlation_csub_plain(fm1t, fm2t, r)
    out = band_csub(fm1t, fm2t, r)
    assert out.shape == ref.shape == (2, 6, 44, (2 * r + 1) ** 2) and out.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)
    else:
        f32 = _corr_sums(fm1t.transpose(2, 3), fm2t.transpose(2, 3), r) * correlation_scale(C)
        err = (out.float() - f32).abs()
        assert (err <= _bf16_ulp(torch.maximum(out.float().abs(), f32.abs())) + 1e-5).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_csub_tiles_match_tpu_kernel(dtype):
    """Band tiles against the TPU kernel (``_corr_csub_kernel``, interpret
    mode) at 1×8×40×48, r=2: f32 within atol 1e-5 (sums in another order),
    bf16 within one bf16 ulp (1e-5 near zero)."""
    rng = np.random.RandomState(3)
    f1, f2 = (rng.randn(1, 8, 40, 48).astype(np.float32) for _ in range(2))
    j1, j2 = (jnp.asarray(x).astype(dtype) for x in (f1, f2))
    ref = local_correlation_pallas_csub(j1, j2, 2, h_tile=8, interpret=True)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    t1, t2 = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(getattr(torch, dtype))
              .transpose(2, 3).contiguous() for x in (j1, j2))
    out = band_csub(t1, t2, 2).float()
    if dtype == "float32":
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    else:
        err = (out - ref).abs()
        assert (err <= _bf16_ulp(torch.maximum(out.abs(), ref.abs())) + 1e-5).all()
