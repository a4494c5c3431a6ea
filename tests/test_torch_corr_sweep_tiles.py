"""The arithmetic of ``ops/csrc/local_corr_sweep.cu``, modelled in torch on the CPU.

The file holds the kernel sweep's two own kernels, rows 8 (``corr_swapped``)
and 9 (``corr_rotmxu``), on one body of tensor-core band products (the body
of ``local_corr_band.cu``). A block owns 4 query rows and a strip of queries
(64 in bf16, 32 in f32) as 16-query sub-strips. For each source row s and
sub-strip j it forms

    D[64 x 32] = A[64 x C] · B[32 x C]^T,

A's rows the sub-strip's 16 queries of all 4 query rows (row 16q + m), B's
rows the source columns x0 + 16j - r + n of row s, zero outside the image
and past C (chunks of 64 bf16 or 32 f32 channels). Element (16q + m, n) is
the product at dy = s - (y0+q) + r, dx = n - m; the epilogues keep those with
both in [0, d). bf16 sums every chunk in the accumulators; f32 runs groups of
256 channels, its products 3xTF32. Only the source rows inside the image are
multiplied; the band of a row outside is written as zeros.

The two epilogues:

* row 9 (NHWC): the band, scaled, goes into a (4, strip, d²) tile (a later
  f32 channel group adding into it) that the block stores at the end,
  rounded once to fm1's dtype: d² lanes, or 128 with lanes d²..127 exact
  zeros.
* row 8 (planar f32, (B, d², H, W)): in bf16, once source row s is
  multiplied, each query row's band is stored, scaled, to planes dx·d + dy
  (no tile); in f32 the bands go into row 9's tile and the block stores it
  to the planes at the end. The wrapper transposes and casts.

This file builds both block by block, on outputs filled with NaN (an element
no store reaches shows), and holds them against the port's plain versions
(the card's yardsticks) and, at one small shape, against the JAX sweep's
``corr_swapped`` and ``corr_rotmxu`` with their Pallas kernels in interpret
mode.
"""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpnet_tpu_torch.bench_tools import corr_sweep as port_sweep
from rpnet_tpu_torch.ops import correlation as tc

torch.set_num_threads(2)   # small shapes; the suite runs several workers on one machine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QR = 4       # query rows a block (one per warp of a warpgroup)
SUB = 16     # queries a sub-strip (one consumer warpgroup)
NB = 32      # source columns a product (16 + 2r <= 32)
LANES = 128  # corr_rotmxu's full_lanes width
# queries a block, channels a chunk (one 128-byte TMA box), chunks a channel
# group (None: all of them, summed in the accumulators)
TILING = {torch.bfloat16: (64, 64, None), torch.float32: (32, 32, 8)}


def tf32(x: torch.Tensor) -> torch.Tensor:
    """What a TF32 tensor core reads of an f32 value: the low 13 bits masked."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def three_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's three TF32 passes (a raw operand is its own big part)."""
    return torch.matmul(tf32(a - tf32(a)), tf32(b)) + torch.matmul(tf32(a), tf32(b - tf32(b))) \
        + torch.matmul(tf32(a), tf32(b))


def sweep_tiles(fm1: torch.Tensor, fm2: torch.Tensor, r: int, kind: str, lanes: int = 0,
                off: int = 0, later_groups: str = "add") -> torch.Tensor:
    """(B, H, W, C) inputs → what the kernel writes: ``swapped`` the planar
    (B, d², H, W) f32 tensor, ``rotmxu`` (B, H, W, lanes) in fm1's dtype
    (``lanes`` d² or 128). ``off`` shifts every product's source window by
    that many columns, ``later_groups="set"`` makes a later f32 channel group
    overwrite the one before (faults the model must show)."""
    B, H, W, C = fm1.shape
    dtype = fm1.dtype
    per_row = kind == "swapped" and dtype == torch.bfloat16   # planes stored a source row at a time
    strip, ck, group = TILING[dtype]
    product = three_tf32 if dtype == torch.float32 else torch.matmul
    d = 2 * r + 1
    dd = d * d
    nsub = strip // SUB
    ny, nx = -(-H // QR), -(-W // strip)
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
    m = torch.arange(SUB)[:, None]
    n = m + torch.arange(d)[None, :]                  # window column of (m, dx)
    nan = float("nan")
    planar = torch.full((B, dd, H, W), nan)
    tile = torch.full((B, ny * QR, nx * strip, d, d), nan)   # [..., x, dx, dy]

    def put(y, dy, v, add):
        """Query row y's band at shift dy, v (B, nx, nsub, SUB, d) as [.., m, dx]."""
        v = v.reshape(B, nx * strip, d)
        if per_row:
            assert not add                                # bf16: one channel group
            if y < H:
                planar[:, torch.arange(d) * d + dy, y] = v[:, :W].transpose(1, 2)   # dx·d + dy
        else:
            tile[:, y, :, :, dy] = tile[:, y, :, :, dy] + v if add else v

    zeros = torch.zeros((B, nx, nsub, SUB, d))
    for by in range(ny):
        y0 = by * QR
        s_lo, s_hi = max(0, y0 - r), min(H - 1, y0 + QR - 1 + r)
        for s in range(y0 - r, y0 + QR + r):
            if not s_lo <= s <= s_hi:                 # zero outside the image
                for q in range(QR):
                    if 0 <= s - (y0 + q) + r < d:
                        put(y0 + q, s - (y0 + q) + r, zeros, False)
        for gi, (g0, g1) in enumerate(groups):
            for s in range(s_lo, s_hi + 1):
                bt = src[:, s][:, cols]               # (B, nx, nsub, NB, cp)
                prod = torch.zeros((B, nx, nsub, QR * SUB, NB))
                for k0 in range(g0, g1, ck):          # chunks summed in f32
                    prod = prod + product(a[:, by, ..., k0:k0 + ck],
                                          bt[..., k0:k0 + ck].transpose(-1, -2))
                for q in range(QR):
                    dy = s - (y0 + q) + r
                    if 0 <= dy < d:
                        v = prod[..., q * SUB:(q + 1) * SUB, :][..., m, n] * scale
                        put(y0 + q, dy, v, gi > 0 and later_groups == "add")
    tile = tile.reshape(B, ny * QR, nx * strip, dd)[:, :H, :W]   # the stores at the block's end
    if kind == "swapped":
        if not per_row:
            planar[:] = tile.permute(0, 3, 1, 2)
        return planar
    out = torch.full((B, H, W, lanes), nan).to(dtype)
    out[..., :dd] = tile.to(dtype)
    if lanes == LANES:
        out[..., dd:] = 0                             # set in registers, never read
    return out


def _inputs(shape, seed, dtype):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)
                 for _ in range(2))


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def _assert_right(out: torch.Tensor, ref: torch.Tensor, f32_sum: torch.Tensor, dtype):
    """f32 within atol 1e-4 of the plain version (3xTF32 products summed in
    another order); bf16 within one bf16 ulp of the f32 sum (1e-5 near zero,
    where f32 sums in another order part by more than their ulp)."""
    assert out.shape == ref.shape and out.dtype == dtype
    if dtype == torch.float32:
        assert (out - ref).abs().max() <= 1e-4
    else:
        err = (out.float() - f32_sum).abs()
        assert (err <= _bf16_ulp(torch.maximum(out.float().abs(), f32_sum.abs())) + 1e-5).all()


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("r", [1, 2, 5])
@pytest.mark.parametrize("C", [16, 48, 320])
def test_swapped_planar_tiles_match_plain(C, r, dtype):
    """Row 8 (H = 10: three rows of blocks, the last past the image; W = 44,
    past one 32-query f32 strip and short of the 64-query bf16 one; C = 16
    and 48 inside one chunk, 320 over five chunks (bf16) or ten in two
    channel groups (f32), the second added into the tile the first wrote):
    every planar element written, and the wrapper's transpose and cast
    against :func:`corr_swapped_plain`."""
    fm1, fm2 = _inputs((2, 10, 44, C), seed=C + r, dtype=dtype)
    planar = sweep_tiles(fm1, fm2, r, "swapped")
    assert planar.shape == (2, (2 * r + 1) ** 2, 10, 44) and planar.dtype == torch.float32
    assert torch.isfinite(planar).all()
    out = planar.permute(0, 2, 3, 1).to(dtype)        # the wrapper's one pass
    ref = port_sweep.corr_swapped_plain(fm1, fm2, r)
    _assert_right(out, ref, tc._corr_sums(fm1, fm2, r) * tc.correlation_scale(C), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("r", [1, 2, 5])
@pytest.mark.parametrize("C", [16, 48, 320])
def test_rotmxu_nhwc_tiles_match_plain(C, r, dtype):
    """Row 9 at row 8's shapes, both output widths: the d² lanes equal bit
    for bit between them and hold against :func:`corr_rotmxu_plain`; with
    128 lanes, lanes d²..127 are exact zeros and every element is written."""
    fm1, fm2 = _inputs((2, 10, 44, C), seed=2 * C + r, dtype=dtype)
    d2 = (2 * r + 1) ** 2
    narrow = sweep_tiles(fm1, fm2, r, "rotmxu", lanes=d2)
    full = sweep_tiles(fm1, fm2, r, "rotmxu", lanes=LANES)
    assert full.shape == (2, 10, 44, LANES) and not torch.isnan(full.float()).any()
    assert torch.equal(full[..., :d2], narrow)
    assert torch.equal(full[..., d2:], torch.zeros_like(full[..., d2:]))
    ref = port_sweep.corr_rotmxu_plain(fm1, fm2, r, full_lanes=True)
    assert torch.equal(ref[..., d2:], torch.zeros_like(ref[..., d2:]))
    _assert_right(full[..., :d2], ref[..., :d2],
                  tc._corr_sums(fm1, fm2, r) * tc.correlation_scale(C), dtype)


@pytest.mark.parametrize("kind", ["swapped", "rotmxu"])
def test_sweep_tiles_window_one_column_off_fails(kind):
    """The model is sharp: every product's source window one column to the
    right gives values far from the plain version's (most outputs move by
    more than the tolerances above)."""
    fm1, fm2 = _inputs((2, 10, 44, 48), seed=7, dtype=torch.float32)
    ref = tc.local_correlation_plain(fm1, fm2, 2)
    outs = []
    for off in (0, 1):
        out = sweep_tiles(fm1, fm2, 2, kind, lanes=25, off=off)
        outs.append(out.permute(0, 2, 3, 1) if kind == "swapped" else out)
    assert (outs[0] - ref).abs().max() <= 1e-4
    assert ((outs[1] - ref).abs() > 1e-2).float().mean() > 0.5


def test_swapped_later_group_overwriting_fails():
    """At C = 320 in f32 (two channel groups) the second group must add to
    the tile: one that overwrites it leaves only its 64 channels."""
    fm1, fm2 = _inputs((2, 10, 44, 320), seed=9, dtype=torch.float32)
    ref = tc.local_correlation_plain(fm1, fm2, 2)
    good = sweep_tiles(fm1, fm2, 2, "swapped").permute(0, 2, 3, 1)
    bad = sweep_tiles(fm1, fm2, 2, "swapped", later_groups="set").permute(0, 2, 3, 1)
    assert (good - ref).abs().max() <= 1e-4
    assert ((bad - ref).abs() > 1e-2).float().mean() > 0.5


@pytest.fixture(scope="module")
def jax_sweep():
    spec = importlib.util.spec_from_file_location(
        "jax_corr_sweep_tiles", os.path.join(ROOT, "bench_tools", "corr_sweep.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(jax_sweep, monkeypatch):
    """The JAX sweep's Pallas kernels in interpret mode (CPU)."""
    monkeypatch.setattr(jax_sweep.pl, "pallas_call",
                        functools.partial(jax_sweep.pl.pallas_call, interpret=True))
    return jax_sweep


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["swapped", "rotmxu"])
def test_sweep_tiles_match_jax_sweep(interpret, kind, dtype):
    """Both models against the JAX sweep (interpret mode) at 2×16×16×64, r=3:
    row 8 through the wrapper's transpose and cast against ``corr_swapped``
    (h_tile 8), row 9 with 128 lanes against ``corr_rotmxu(full_lanes=True)``
    (w_tile 8); f32 within atol 1e-5 (3xTF32 drops about 2^-19 of each
    product), bf16 within one bf16 ulp (1e-5 near zero)."""
    rng = np.random.RandomState(21)
    j = [jnp.asarray(rng.randn(2, 16, 16, 64).astype(np.float32)).astype(dtype)
         for _ in range(2)]
    t = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(getattr(torch, dtype)) for x in j]
    if kind == "swapped":
        ref = interpret.corr_swapped(j[0], j[1], 3, h_tile=8)
        out = sweep_tiles(t[0], t[1], 3, kind).permute(0, 2, 3, 1).to(t[0].dtype)
    else:
        ref = interpret.corr_rotmxu(j[0], j[1], 3, w_tile=8, full_lanes=True)
        out = sweep_tiles(t[0], t[1], 3, kind, lanes=LANES)
        assert torch.equal(out[..., 49:], torch.zeros_like(out[..., 49:]))
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    out = out.float()
    assert out.shape == ref.shape
    if dtype == "float32":
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    else:
        assert ((out - ref).abs() <= _bf16_ulp(torch.maximum(out.abs(), ref.abs())) + 1e-5).all()
