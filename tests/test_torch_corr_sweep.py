"""The kernel sweep's two own kernels (rows 8 and 9) and the sweep itself.

The port's ``corr_swapped`` and ``corr_rotmxu`` (``rpnet_tpu_torch.bench_tools.
corr_sweep``; on CPU tensors their plain versions) are held against the JAX
sweep's functions of the same names (``bench_tools/corr_sweep.py``), whose
Pallas kernels run in interpret mode: the test patches that module's
``pl.pallas_call`` with ``interpret=True``. Inputs 2×16×16×64, r=3, from
numpy. Tolerances: f32 within 1e-5 (sums over C=64 in another order); bf16
within one bf16 ulp (rtol 2**-7, atol 1e-3), both sides rounding an f32 sum
of exact products once. The port's sweep (``main``) runs every line on the
CPU at the same shape, each within its tolerance.
"""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpnet_tpu_torch.bench_tools import corr_sweep as port_sweep
from rpnet_tpu_torch.ops.correlation import local_correlation_plain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE, R = (2, 16, 16, 64), 3


@pytest.fixture(scope="module")
def jax_sweep():
    spec = importlib.util.spec_from_file_location(
        "jax_corr_sweep", os.path.join(ROOT, "bench_tools", "corr_sweep.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(jax_sweep, monkeypatch):
    """The JAX sweep's Pallas kernels in interpret mode (CPU)."""
    monkeypatch.setattr(jax_sweep.pl, "pallas_call",
                        functools.partial(jax_sweep.pl.pallas_call, interpret=True))
    return jax_sweep


def _inputs(seed, dtype, shape=SHAPE):
    rng = np.random.RandomState(seed)
    a, b = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    ja, jb = jnp.asarray(a).astype(dtype), jnp.asarray(b).astype(dtype)
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    ta, tb = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdtype) for x in (ja, jb))
    return (ja, jb), (ta, tb)


def _assert_close(out, ref, dtype):
    out = out.float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    assert out.shape == ref.shape
    if dtype == jnp.bfloat16:
        np.testing.assert_allclose(out, ref, rtol=2 ** -7, atol=1e-3)
    else:
        np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("dtype,h_tile", [(jnp.float32, 8), (jnp.float32, 16),
                                          (jnp.bfloat16, 16)])
def test_corr_swapped_matches_jax_sweep(interpret, dtype, h_tile):
    """Row 8: (B, H, W, d²) in the input dtype, after the planar kernel's
    transpose and cast."""
    (ja, jb), (ta, tb) = _inputs(1, dtype)
    ref = interpret.corr_swapped(ja, jb, R, h_tile=h_tile)
    out = port_sweep.corr_swapped(ta, tb, R, h_tile=h_tile)
    assert out.dtype == ta.dtype and ref.dtype == ja.dtype
    _assert_close(out, ref, dtype)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("full_lanes", [False, True])
@pytest.mark.parametrize("out_f32", [True, False])
def test_corr_rotmxu_matches_jax_sweep(interpret, dtype, full_lanes, out_f32):
    """Row 9 under every output option: d² or 128 lanes, whose padding is
    exactly zero in both packages; ``out_f32`` changes no value."""
    (ja, jb), (ta, tb) = _inputs(2, dtype)
    d2 = (2 * R + 1) ** 2
    ref = interpret.corr_rotmxu(ja, jb, R, w_tile=8, full_lanes=full_lanes,
                                out_f32=out_f32)
    out = port_sweep.corr_rotmxu(ta, tb, R, w_tile=8, full_lanes=full_lanes,
                                 out_f32=out_f32)
    lanes = 128 if full_lanes else d2
    assert out.shape == tuple(ref.shape) == SHAPE[:3] + (lanes,)
    assert out.dtype == ta.dtype and ref.dtype == ja.dtype
    _assert_close(out, ref, dtype)
    if full_lanes:
        assert not np.asarray(ref[..., d2:].astype(jnp.float32)).any()
        assert torch.equal(out[..., d2:], torch.zeros_like(out[..., d2:]))


def test_rotmxu_equals_plain_correlation():
    """Row 9's plain version is the local correlation's in the first d²
    lanes, in both output widths."""
    _, (ta, tb) = _inputs(3, jnp.bfloat16)
    plain = local_correlation_plain(ta, tb, R)
    for full in (False, True):
        out = port_sweep.corr_rotmxu_plain(ta, tb, R, full_lanes=full)
        assert torch.equal(out[..., :plain.shape[-1]], plain)


def test_rotmxu_height_limit_raises_in_both(jax_sweep):
    """H + 2r > 128 raises in both packages (the rotate variant's assert)."""
    (ja, jb), (ta, tb) = _inputs(4, jnp.float32, shape=(1, 120, 8, 16))
    with pytest.raises(AssertionError, match="H\\+2r <= 128"):
        jax_sweep.corr_rotmxu(ja, jb, 5)
    with pytest.raises(ValueError, match="H\\+2r <= 128"):
        port_sweep.corr_rotmxu(ta, tb, 5)
    # at the limit both run
    assert port_sweep.corr_rotmxu(ta[:, :118], tb[:, :118], 5).shape == (1, 118, 8, 121)


def test_sweep_main_on_cpu(capsys):
    """Every line of the sweep runs on the CPU and holds its tolerance."""
    failures = port_sweep.main(SHAPE, R, device="cpu", reps=1)
    out = capsys.readouterr().out
    assert failures == []
    assert "FAILED" not in out and "MISSED" not in out
    for name in ("xla f32", "pallas f32", "pallas-swapped f32 ht=8",
                 "pallas-swapped f32 ht=32", "pallas-mxu f32", "pallas-csub bf16",
                 "pallas bf16 f32-out", "pallas-swapped bf16 ht=16",
                 "pallas-rotmxu f32", "pallas-rotmxu bf16out",
                 "pallas-rotmxu bf16 full_lanes", "bwd pallas", "best fwd"):
        assert name in out, name
    assert out.count("not carried") == 2
    assert out.count("maxerr") == 18


def test_sweep_filters(capsys, monkeypatch):
    """SWEEP_ONLY selects lines by substring; without "bwd" the backward
    lines are skipped, as in the JAX sweep."""
    monkeypatch.setenv("SWEEP_ONLY", "rotmxu")
    assert port_sweep.main(SHAPE, R, device="cpu", reps=1) == []
    out = capsys.readouterr().out
    assert out.count("maxerr") == 4 and "bwd" not in out
    monkeypatch.delenv("SWEEP_ONLY")
    monkeypatch.setenv("SWEEP_BWD_ONLY", "1")
    assert port_sweep.main(SHAPE, R, device="cpu", reps=1) == []
    out = capsys.readouterr().out
    assert out.count("maxerr") == 2 and out.startswith("bwd")


def test_sweep_failure_is_reported(capsys, monkeypatch):
    """A line that raises prints FAILED and is returned; the others run."""
    def broken(*a, **k):
        raise RuntimeError("launch refused")

    monkeypatch.setattr(port_sweep, "corr_swapped", broken)
    monkeypatch.setenv("SWEEP_ONLY", "swapped,rotmxu f32")
    failures = port_sweep.main(SHAPE, R, device="cpu", reps=1)
    out = capsys.readouterr().out
    assert failures == ["pallas-swapped f32 ht=8", "pallas-swapped f32 ht=16",
                        "pallas-swapped f32 ht=32", "pallas-swapped bf16 ht=16"]
    assert out.count("FAILED: RuntimeError: launch refused") == 4
    assert "pallas-rotmxu f32" in out


def test_sweep_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="runs on the card"):
        port_sweep.main(SHAPE, R)
