"""The arithmetic of ``ops/csrc/local_corr_band.cu``, modelled in torch on the CPU.

The kernel computes the local correlation of the three opt-in forwards it
replaces (band, ``RPNET_CORR_IMPL=pallas_mxu``; pdot,
``RPNET_ROT_EXTRACT=pdot``; pack, ``RPNET_ROT_PACK=1``) as band products on
the tensor cores. A block owns 4 query rows and a strip of queries (64 in
bf16, 32 in f32) as 16-query sub-strips. For each source row s and
sub-strip j it forms

    D[64 x 32] = A[64 x C] · B[32 x C]^T,

A's rows the sub-strip's 16 queries of all 4 query rows (row 16q + m), B's
rows the source columns x0 + 16j - r + n of row s, zero outside the image
and past C (channels in chunks of 64 bf16 or 32 f32). Element (16q + m, n) is
the product at dy = s - (y0+q) + r, dx = n - m; the epilogue keeps those
with both in [0, d). bf16 sums every chunk in the accumulators (fm1's
chunks from registers or from a resident copy, the same values); f32 in
groups of 256 channels, each group's D scaled and added into the output
tile, its products 3xTF32. Only the source rows inside the image are
multiplied. The epilogues: band scales and rounds once; pdot rounds S to
bf16, multiplies by bf16(scale) and rounds again; pack zeroes a product
whose source column leaves the query's slice (slice pairs side by side,
``width`` columns each).

This file builds those products block by block, extracts the band as the
kernel does and holds the result against the plain versions (the card's
yardsticks), and at small shapes against the TPU kernels the instances
replace (``_corr_mxu_kernel``, ``_corr_rot2_kernel`` and ``_corr_rot_kernel``
with ``pdot=True``, interpret mode).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpnet_tpu.ops.pallas import correlation as pc
from rpnet_tpu_torch.ops import correlation as tc

torch.set_num_threads(2)   # small shapes; the suite runs several workers on one machine

QR = 4       # query rows a block (one per warp of a warpgroup)
SUB = 16     # queries a sub-strip (one consumer warpgroup)
NB = 32      # source columns a product (16 + 2r <= 32)
# queries a block, channels a chunk (one 128-byte TMA box), chunks summed in
# the accumulators before the tile (None: all of them)
TILING = {torch.bfloat16: (64, 64, None), torch.float32: (32, 32, 8)}


def tf32(x: torch.Tensor) -> torch.Tensor:
    """What a TF32 tensor core reads of an f32 value: the low 13 bits masked."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def three_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's three TF32 passes (a raw operand is its own big part)."""
    return torch.matmul(tf32(a - tf32(a)), tf32(b)) + torch.matmul(tf32(a), tf32(b - tf32(b))) \
        + torch.matmul(tf32(a), tf32(b))


def band_tiles(fm1: torch.Tensor, fm2: torch.Tensor, r: int, mode: str = "band",
               width: int = 0, off: int = 0) -> torch.Tensor:
    """(B, H, W, C) inputs (pack: slice pairs side by side, ``width`` columns
    each) → the (B, H, W, d²) output as the kernel's tiles compute it.
    ``off`` shifts every product's source window by that many columns (a
    fault the model must show)."""
    B, H, W, C = fm1.shape
    dtype = fm1.dtype
    strip, ck, group = TILING[dtype]
    product = three_tf32 if dtype == torch.float32 else torch.matmul
    width = width or W
    d = 2 * r + 1
    nsub = strip // SUB
    ny = -(-H // QR)
    nx = -(-W // strip)
    cp = -(-C // ck) * ck                             # boxes past C arrive zero-filled
    scale = tc.correlation_scale(C)
    a = torch.zeros((B, ny * QR, nx * strip, cp))
    a[:, :H, :W, :C] = fm1.float()
    a = a.view(B, ny, QR, nx, nsub, SUB, cp).permute(0, 1, 3, 4, 2, 5, 6)
    a = a.reshape(B, ny, nx, nsub, QR * SUB, cp)
    # fm2 staged from column x0 - r: staged column i of block bx is index
    # bx·strip + i here; sub-strip j's window starts 16j columns in
    src = torch.zeros((B, H, nx * strip + NB + 1, cp))
    src[:, :, r:r + W, :C] = fm2.float()
    cols = (torch.arange(nx)[:, None, None] * strip + torch.arange(nsub)[None, :, None] * SUB
            + off + torch.arange(NB))                 # (nx, nsub, NB)
    groups = [(0, cp)] if group is None else [(g, min(cp, g + group * ck))
                                              for g in range(0, cp, group * ck)]
    x = torch.arange(nx * strip).view(nx, nsub, SUB)
    m = torch.arange(SUB)[:, None]
    n = m + torch.arange(d)[None, :]                  # window column of (m, dx)
    src_col = (x % width)[..., None] + torch.arange(d) - r   # in the query's slice, (.., SUB, d)
    inside = (src_col >= 0) & (src_col < width)
    tile = torch.zeros((B, ny * QR, nx, nsub, SUB, d, d))   # [..., m, dx, dy]
    for by in range(ny):
        y0 = by * QR
        for s in range(max(0, y0 - r), min(H - 1, y0 + QR - 1 + r) + 1):
            bt = src[:, s][:, cols]                    # (B, nx, nsub, NB, cp)
            for g0, g1 in groups:
                dd = torch.zeros((B, nx, nsub, QR * SUB, NB))
                for k0 in range(g0, g1, ck):           # chunks summed in f32
                    dd = dd + product(a[:, by, ..., k0:k0 + ck],
                                      bt[..., k0:k0 + ck].transpose(-1, -2))
                for q in range(QR):
                    dy = s - (y0 + q) + r
                    if not 0 <= dy < d:
                        continue
                    v = dd[..., q * SUB:(q + 1) * SUB, :][..., m, n]   # (B, nx, nsub, SUB, d)
                    if mode == "pdot":
                        sb = float(torch.tensor(scale, dtype=torch.bfloat16))
                        v = v.to(torch.bfloat16).float() * sb
                    else:
                        v = v * scale
                        if mode == "pack":
                            v = torch.where(inside, v, 0.0)
                    tile[:, y0 + q, ..., dy] += v
    out = tile.reshape(B, ny * QR, nx * strip, d * d)[:, :H, :W]
    return out.to(dtype)


def _inputs(shape, seed, dtype, partner=1.0, width=0):
    """(B, H, W, C) inputs of ``dtype`` from a seed; with ``width``, the
    columns from ``width`` on (a pair's second slice) ``partner`` times larger."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(2):
        x = rng.randn(*shape).astype(np.float32)
        if width:
            x[:, :, width:] *= partner
        out.append(torch.from_numpy(x).to(dtype))
    return tuple(out)


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def _pdot_close(out: torch.Tensor, ref: torch.Tensor, s: torch.Tensor, C: int) -> bool:
    """pdot values within one bf16 ulp of S carried through the scale, plus
    one ulp of the result (the two f32 sums S may straddle a rounding
    boundary; 1e-5 near zero)."""
    sb = float(torch.tensor(tc.correlation_scale(C), dtype=torch.bfloat16))
    out, ref = out.float(), ref.float()
    tol = _bf16_ulp(s) * sb + _bf16_ulp(torch.maximum(out.abs(), ref.abs())) + 1e-5
    return bool(((out - ref).abs() <= tol).all())


CASES = [("band", torch.float32), ("band", torch.bfloat16), ("pdot", torch.bfloat16),
         ("pack", torch.float32), ("pack", torch.bfloat16)]


@pytest.mark.parametrize("mode,dtype", CASES, ids=[f"{m}-{str(d)[6:]}" for m, d in CASES])
@pytest.mark.parametrize("r", [1, 2, 5])
@pytest.mark.parametrize("C", [16, 48, 320])
def test_band_tiles_match_plain(C, r, mode, dtype):
    """The tiles (H = 10: three rows of blocks, the last past the image;
    W = 44, past one 32-query f32 strip and short of the 64-query bf16 one;
    C = 16 and 48 inside one chunk, 320 over five (bf16) or ten in two
    groups (f32)) against the plain versions: f32 within atol 1e-4 (times the
    slice scale² for pack); bf16 within one bf16 ulp of the f32 sum (1e-5
    near zero, where f32 sums in another order part by more than their ulp);
    pdot within one ulp of S through the scale plus one of the result. Pack
    runs on one slice pair of width 22, the second slice 300 (f32) or 30
    (bf16) times larger: a query reading its partner's columns would be off
    by that much."""
    width = 22 if mode == "pack" else 0
    partner = (300.0 if dtype == torch.float32 else 30.0) if mode == "pack" else 1.0
    B = 1 if mode == "pack" else 2
    fm1, fm2 = _inputs((B, 10, 44, C), seed=C + r, dtype=dtype, partner=partner, width=width)
    out = band_tiles(fm1, fm2, r, mode, width)
    assert out.shape == (B, 10, 44, (2 * r + 1) ** 2) and out.dtype == dtype
    if mode == "pack":
        ref = tc.local_correlation_packed_plain(fm1, fm2, r, width)
    elif mode == "pdot":
        ref = tc.local_correlation_pdot_plain(fm1, fm2, r)
    else:
        ref = tc.local_correlation_plain(fm1, fm2, r)
    sums = tc._corr_sums(fm1, fm2, r, width=width)
    if mode == "pdot":
        assert _pdot_close(out, ref, sums, C)
    elif dtype == torch.float32:
        slice_sq = torch.ones(44)
        slice_sq[width or 44:] = partner ** 2
        assert ((out - ref).abs() / slice_sq[:, None]).max() <= 1e-4
    else:
        f32 = sums * tc.correlation_scale(C)
        err = (out.float() - f32).abs()
        assert (err <= _bf16_ulp(torch.maximum(out.float().abs(), f32.abs())) + 1e-5).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_band_tiles_window_one_column_off_fails(dtype):
    """The model is sharp: every product's source window one column to the
    right gives values far from the plain version's (most outputs move by
    more than the tolerance above)."""
    fm1, fm2 = _inputs((2, 10, 44, 48), seed=7, dtype=dtype)
    ref = tc.local_correlation_plain(fm1, fm2, 2).float()
    assert torch.allclose(band_tiles(fm1, fm2, 2).float(), ref, rtol=2 ** -7, atol=1e-3)
    off = band_tiles(fm1, fm2, 2, off=1).float()
    assert ((off - ref).abs() > 1e-2).float().mean() > 0.5


def _jax_pair(shape, seed, dtype):
    """The same values as a JAX and a torch pair."""
    rng = np.random.RandomState(seed)
    j = [jnp.asarray(rng.randn(*shape).astype(np.float32)).astype(dtype) for _ in range(2)]
    t = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(getattr(torch, dtype)) for x in j]
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_band_tiles_match_corr_mxu_kernel(dtype):
    """Band against ``_corr_mxu_kernel`` (interpret mode) at 2×8×20×32, r=2:
    f32 within atol 1e-5 (sums in another order; 3xTF32 drops about 2^-19
    of each product), bf16 within one bf16 ulp (1e-5 near zero)."""
    (j1, j2), (t1, t2) = _jax_pair((2, 8, 20, 32), 11, dtype)
    ref = pc.local_correlation_pallas_mxu(j1, j2, 2, h_tile=8, interpret=True)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    out = band_tiles(t1, t2, 2).float()
    if dtype == "float32":
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    else:
        assert ((out - ref).abs() <= _bf16_ulp(torch.maximum(out.abs(), ref.abs())) + 1e-5).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_band_tiles_match_rot2_kernel(dtype):
    """Pack against ``_corr_rot2_kernel`` (the packed impl, interpret mode)
    at 2×8×64×16, r=2, on the pair packed side by side (2W = 128, what the
    TPU kernel takes): f32 within atol 1e-5, bf16 within one bf16 ulp."""
    (j1, j2), (t1, t2) = _jax_pair((2, 8, 64, 16), 12, dtype)
    out128 = pc._local_correlation_pallas_rot_impl(j1, j2, 2, h_tile=8, interpret=True,
                                                    pack=True)
    ref = torch.from_numpy(np.array(pc.rot_to_quirk(out128, 2).astype(jnp.float32)))
    out = tc.unpack_pairs(band_tiles(tc.pack_pairs(t1), tc.pack_pairs(t2), 2, "pack",
                                     width=64)).float()
    if dtype == "float32":
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    else:
        assert ((out - ref).abs() <= _bf16_ulp(torch.maximum(out.abs(), ref.abs())) + 1e-5).all()


def test_band_tiles_match_rot_kernel_pdot():
    """Pdot against ``_corr_rot_kernel(pdot=True)`` (interpret mode) at
    2×8×16×48, r=2 (a scale that is not a power of two), with pdot's
    tolerance."""
    (j1, j2), (t1, t2) = _jax_pair((2, 8, 16, 48), 13, "bfloat16")
    out128 = pc._local_correlation_pallas_rot_impl(j1, j2, 2, h_tile=8, interpret=True,
                                                    pdot=True)
    ref = torch.from_numpy(np.array(pc.rot_to_quirk(out128, 2).astype(jnp.float32)))
    out = band_tiles(t1, t2, 2, "pdot")
    assert _pdot_close(out, ref, tc._corr_sums(t1, t2, 2), 48)
