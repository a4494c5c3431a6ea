"""The arithmetic of ``ops/csrc/local_corr_bwd.cu``, modelled in torch on the CPU.

The kernel computes both input gradients of the local correlation as
transposed band products: for an output row y, a vertical shift dy and a
tile of 8 queries x0..x0+7,

    out^T[c, x] += sum_j src[y+dy-r, x0-r+j, c] * band[j, x - x0],
    band[j, n] = w[y, x0+n, dy, j-n] where 0 <= j-n < d, else 0,

with j padded to KT (a multiple of the MMA depth: 8 for TF32, 16 for bf16),
zeros outside the image, src = fm2 and w[y,x,dy,dx] = g[y,x,dx*d+dy] for
dfm1, src = fm1 and w gathered from g's source pixels for dfm2. This file
builds those band matrices tile by tile as the kernel does, contracts them
with ``torch.matmul`` and holds the result against
``local_correlation_bwd_plain`` (the card's yardstick), so the index map is
tested before any chip call. The f32 kernel's 3xTF32 split (low 13 bits
masked, small*small dropped) is modelled too and held to the card's atol.
"""

import numpy as np
import pytest
import torch

from rpnet_tpu_torch.ops.correlation import (correlation_scale,
                                             local_correlation_bwd_plain)

torch.set_num_threads(2)   # small shapes; the suite runs several workers on one machine

QT = 8   # queries a tile (the MMA's N)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """What a TF32 tensor core reads of an f32 value: the low 13 bits masked."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def three_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's three TF32 passes, summed in f32."""
    ab, bb = tf32(a), tf32(b)
    return (torch.matmul(tf32(a - ab), bb) + torch.matmul(ab, tf32(b - bb))
            + torch.matmul(ab, bb))


def band_weights(g: torch.Tensor, r: int, second: bool) -> torch.Tensor:
    """w[b, y, x, dy, dx] of one gradient, zero outside the image: dfm1's
    from g's own pixel, dfm2's from g[q + (dy-r, dx-r), (2r-dx)*d + 2r-dy]."""
    B, H, W, _ = g.shape
    d = 2 * r + 1
    w = torch.zeros((B, H, W, d, d), dtype=g.dtype)
    gp = torch.nn.functional.pad(g, (0, 0, r, r, r, r))
    for dx in range(d):
        for dy in range(d):
            if second:
                k = (2 * r - dx) * d + 2 * r - dy
                w[:, :, :, dy, dx] = gp[:, dy:dy + H, dx:dx + W, k]
            else:
                w[:, :, :, dy, dx] = g[..., dx * d + dy]
    return w


def band_bwd(g, fm1, fm2, r: int, kstep: int, product=torch.matmul):
    """(dfm1, dfm2) as the kernel's tiles compute them: f32 sums (f64 for
    f64 inputs)."""
    B, H, W, C = fm1.shape
    acc = torch.float64 if fm1.dtype == torch.float64 else torch.float32
    d = 2 * r + 1
    kt = -(-(QT + 2 * r) // kstep) * kstep      # band depth, padded
    nq = -(-W // QT)                            # query tiles
    outs = []
    for second, src in ((False, fm2), (True, fm1)):
        w = band_weights(g.to(acc), r, second)
        # source rows y-r .. y+r, columns x0-r .. x0-r+kt-1 of every tile
        wcols = (nq - 1) * QT + kt
        sp = torch.zeros((B, H + 2 * r, wcols, C), dtype=acc)
        sp[:, r:r + H, r:r + W] = src.to(acc)[:, :, :wcols - r]
        wq = torch.zeros((B, H, nq * QT, d, d), dtype=acc)
        wq[:, :, :W] = w
        out = torch.zeros((B, H, nq * QT, C), dtype=acc)
        j = torch.arange(kt)[:, None]
        n = torch.arange(QT)[None, :]
        dx = j - n                                  # (kt, QT)
        inside = (dx >= 0) & (dx < d)
        for q in range(nq):
            x0 = q * QT
            for dy in range(d):
                a = sp[:, dy:dy + H, x0:x0 + kt].transpose(-1, -2)    # (B, H, C, kt)
                wt = wq[:, :, x0:x0 + QT, dy]                          # (B, H, QT, d)
                band = torch.where(inside, wt[:, :, n[0], dx.clamp(0, d - 1)],
                                   torch.zeros((), dtype=acc))         # (B, H, kt, QT)
                out[:, :, x0:x0 + QT] += product(a, band).transpose(-1, -2)
        outs.append((out[:, :, :W] * correlation_scale(C)).to(fm1.dtype))
    return tuple(outs)


def inputs(B, H, W, C, r, seed, dtype=torch.float32):
    """fm1, fm2 and g as a strided (B, H, W, d²) view of a concat gradient
    (B, H, W, d² + C), as the CRE hands it to the backward."""
    rng = np.random.RandomState(seed)
    d2 = (2 * r + 1) ** 2
    fm1, fm2 = (torch.from_numpy(rng.randn(B, H, W, C).astype(np.float32)).to(dtype)
                for _ in range(2))
    cat = torch.from_numpy(rng.randn(B, H, W, d2 + C).astype(np.float32)).to(dtype)
    return cat[..., :d2], fm1, fm2


@pytest.mark.parametrize("r", [1, 3, 5])
@pytest.mark.parametrize("C", [48, 80])
@pytest.mark.parametrize("W", [20, 72, 100])
def test_band_tiles_match_plain(W, C, r):
    """Band tiles with f32 products (the k8 padding of the TF32 kernel) and
    with k16 padding (the bf16 kernel's) equal the plain backward up to the
    order of f32 sums, both gradients, ragged W and H, strided g."""
    g, fm1, fm2 = inputs(2, 6, W, C, r, seed=W + C + r)
    assert g.stride(2) == (2 * r + 1) ** 2 + C    # the concat's pixel pitch
    ref = local_correlation_bwd_plain(g, fm1, fm2, r)
    for kstep in (8, 16):
        out = band_bwd(g, fm1, fm2, r, kstep)
        for o, p in zip(out, ref):
            assert o.shape == p.shape
            torch.testing.assert_close(o, p, rtol=0, atol=2e-5)


def test_band_tiles_bf16():
    """bf16 inputs (exact products, f32 sums, one rounding): within one bf16
    ulp of the plain backward."""
    g, fm1, fm2 = inputs(2, 5, 20, 48, 2, seed=3, dtype=torch.bfloat16)
    ref = local_correlation_bwd_plain(g, fm1, fm2, 2)
    for o, p in zip(band_bwd(g, fm1, fm2, 2, 16), ref):
        assert o.dtype == torch.bfloat16
        torch.testing.assert_close(o.float(), p.float(), rtol=2 ** -7, atol=1e-3)


def test_three_tf32_error_at_full_width():
    """The 3xTF32 model at C=256, r=5 (the training shape's channels and
    radius): its error against the backward in f64 stays under the card's
    atol of 1e-4 on the f32 kernel (measured 1.3e-6), while one TF32 pass
    does not (2e-3)."""
    g, fm1, fm2 = inputs(1, 12, 16, 256, 5, seed=7)
    exact = band_bwd(g.double(), fm1.double(), fm2.double(), 5, 8)   # f64 sums
    emulated = band_bwd(g, fm1, fm2, 5, 8, product=three_tf32)
    one_pass = band_bwd(g, fm1, fm2, 5, 8,
                        product=lambda a, b: torch.matmul(tf32(a), tf32(b)))
    err3 = max((o.double() - e).abs().max().item() for o, e in zip(emulated, exact))
    err1 = max((o.double() - e).abs().max().item() for o, e in zip(one_pass, exact))
    assert err3 < 1e-4, err3
    assert err1 > 1e-4, err1
