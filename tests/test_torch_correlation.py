"""rpnet_tpu_torch local correlation vs the JAX package.

The port's plain versions (what its wrappers run on CPU tensors) are held
against the JAX shifted-products ``local_correlation`` and its ``jax.vjp``,
and against the TPU kernels the port replaces — ``_corr_rot_kernel`` in
select mode and the backward ``_corr_bwd_kernel`` — run in Pallas interpret
mode as ``tests/test_ops.py`` runs them. The autograd Function is held
against torch autograd of the plain forward. The Hopper kernels themselves
run only on the card; ``chip_smoke.py`` holds them against the plain
versions there.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from rpnet_tpu.ops.correlation import local_correlation as jax_local_correlation
from rpnet_tpu.ops.pallas.correlation import (local_correlation_pallas,
                                              local_correlation_pallas_bwd,
                                              local_correlation_pallas_rot,
                                              rot_to_quirk)
from rpnet_tpu_torch.ops.correlation import (local_correlation,
                                             local_correlation_bwd,
                                             local_correlation_bwd_plain,
                                             local_correlation_plain,
                                             local_correlation_trainable)

torch.set_num_threads(2)   # small shapes; the suite runs several workers on one machine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(seed, shape=(2, 16, 16, 64)):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


@pytest.mark.parametrize("r", [1, 2, 5])
def test_plain_matches_jax_local_correlation(r):
    """Quirk channel order c = dx·d + dy, f32 (atol 1e-5: sums over C=64
    taken in another order)."""
    f1, f2 = _inputs(r)
    ref = np.asarray(jax_local_correlation(jnp.asarray(f1), jnp.asarray(f2), r))
    out = local_correlation_plain(torch.from_numpy(f1), torch.from_numpy(f2), r)
    assert out.shape == (2, 16, 16, (2 * r + 1) ** 2) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("r,h_tile", [(2, 8), (5, 16)])
def test_plain_matches_rot_kernel(r, h_tile):
    """The ported TPU kernel (interpret mode, f32 out) after its channel
    permutation back to the quirk order."""
    f1, f2 = _inputs(10 + r)
    out128 = local_correlation_pallas_rot(jnp.asarray(f1), jnp.asarray(f2), r,
                                          h_tile=h_tile, interpret=True,
                                          out_f32=True)
    ref = np.asarray(rot_to_quirk(out128, r))
    out = local_correlation_plain(torch.from_numpy(f1), torch.from_numpy(f2), r)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_plain_bf16_single_rounding_matches_rot_kernel():
    """bf16 in → bf16 out, the f32 sum rounded once: within one bf16 ulp of
    the JAX rot kernel's bf16 output (the two sums differ only in order)."""
    r = 5
    f1, f2 = _inputs(3)
    j1 = jnp.asarray(f1).astype(jnp.bfloat16)
    j2 = jnp.asarray(f2).astype(jnp.bfloat16)
    ref = np.asarray(rot_to_quirk(local_correlation_pallas_rot(
        j1, j2, r, h_tile=16, interpret=True), r).astype(jnp.float32))
    t1 = torch.from_numpy(np.array(j1.astype(jnp.float32))).to(torch.bfloat16)
    t2 = torch.from_numpy(np.array(j2.astype(jnp.float32))).to(torch.bfloat16)
    out = local_correlation_plain(t1, t2, r)
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    mag = np.maximum(np.abs(out), np.abs(ref))
    ulp = np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30))) - 7), 0.0)
    assert np.all(np.abs(out - ref) <= ulp)
    # and the single rounding is the f32 result rounded once
    f32 = local_correlation_plain(t1.float(), t2.float(), r)
    np.testing.assert_array_equal(out, f32.to(torch.bfloat16).float().numpy())


def _bf16_ulp(x):
    """One bf16 ulp at each element's magnitude (0 where it is 0)."""
    mag = np.abs(x)
    return np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30))) - 7), 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 6, 72, 48), (1, 4, 100, 80)])
def test_plain_at_the_kernel_tiling_edges(shape, dtype):
    """The card's yardstick where the bf16 kernel's tiling changes: W past
    one 64-query strip and not a multiple of it, C not a multiple of its
    64-channel chunk, r=5. Held against the JAX package's local_correlation
    and both TPU kernels local_corr.cu replaces, in interpret mode:
    ``_corr_rot_kernel`` (select) and ``_corr_kernel``. f32 within atol
    1e-5 (sums in another order); bf16 is the f32 sum rounded once, within
    one bf16 ulp of each reference."""
    r = 5
    f1, f2 = _inputs(60 + shape[2], shape)
    j1 = jnp.asarray(f1).astype(dtype)
    j2 = jnp.asarray(f2).astype(dtype)
    w1, w2 = j1.astype(jnp.float32), j2.astype(jnp.float32)   # the values, in f32
    t1 = torch.from_numpy(np.array(w1)).to(getattr(torch, dtype))
    t2 = torch.from_numpy(np.array(w2)).to(getattr(torch, dtype))
    out = local_correlation_plain(t1, t2, r)
    assert out.dtype == t1.dtype and out.shape == shape[:3] + ((2 * r + 1) ** 2,)
    out = out.float().numpy()
    refs = {
        "xla": np.asarray(jax_local_correlation(w1, w2, r)),
        "select": np.asarray(rot_to_quirk(local_correlation_pallas_rot(
            j1, j2, r, h_tile=shape[1], interpret=True, out_f32=True), r)),
        "corr_kernel": np.asarray(local_correlation_pallas(
            j1, j2, r, interpret=True).astype(jnp.float32)),
    }
    if dtype == "float32":
        for name, ref in refs.items():
            np.testing.assert_allclose(out, ref, atol=1e-5, err_msg=name)
    else:
        f32 = local_correlation_plain(t1.float(), t2.float(), r)
        np.testing.assert_array_equal(out, f32.to(torch.bfloat16).float().numpy())
        for name, ref in refs.items():
            assert np.all(np.abs(out - ref) <= _bf16_ulp(np.maximum(np.abs(out), np.abs(ref)))
                          + 1e-6), name


def test_wrapper_sends_cpu_tensors_to_plain_version():
    f1, f2 = _inputs(7, (1, 8, 12, 16))
    local_correlation.launches = 0
    a, b = torch.from_numpy(f1), torch.from_numpy(f2)
    out = local_correlation(a, b, 2)
    np.testing.assert_array_equal(out.numpy(), local_correlation_plain(a, b, 2).numpy())
    assert local_correlation.launches == 0


def test_wrapper_raises_off_cpu_without_cuda():
    """A tensor that is not on the CPU never takes the plain version."""
    a = torch.empty((1, 4, 4, 8), device="meta")
    with pytest.raises(ValueError):
        local_correlation(a, a, 1)


def test_import_needs_neither_nvcc_nor_triton():
    code = ("import sys; import rpnet_tpu_torch.ops.correlation, "
            "rpnet_tpu_torch.ops.kernels as k, rpnet_tpu_torch.models.rpnet; "
            "assert 'triton' not in sys.modules; assert not k._libs")
    env = dict(os.environ, PATH="", PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _grad_inputs(seed, r, shape=(2, 16, 16, 64)):
    f1, f2 = _inputs(seed, shape)
    g = np.random.RandomState(seed + 100).randn(*shape[:3], (2 * r + 1) ** 2)
    return f1, f2, g.astype(np.float32)


@pytest.mark.parametrize("r", [1, 2, 5])
def test_bwd_plain_matches_jax_vjp(r):
    """Both input gradients vs jax.vjp of the JAX package's local_correlation,
    f32 (atol 1e-5: sums over d² shifts in another order)."""
    f1, f2, g = _grad_inputs(20 + r, r)
    # jitted: one compile instead of an eager dispatch per shifted product
    ref1, ref2 = jax.jit(lambda a, b, ct: jax.vjp(
        lambda x, y: jax_local_correlation(x, y, r), a, b)[1](ct))(f1, f2, g)
    d1, d2 = local_correlation_bwd_plain(torch.from_numpy(g), torch.from_numpy(f1),
                                         torch.from_numpy(f2), r)
    assert d1.dtype == d2.dtype == torch.float32
    np.testing.assert_allclose(d1.numpy(), np.asarray(ref1), atol=1e-5)
    np.testing.assert_allclose(d2.numpy(), np.asarray(ref2), atol=1e-5)


@pytest.mark.parametrize("r", [1, 2, 5])
def test_bwd_plain_matches_pallas_bwd_kernel(r):
    """The ported TPU backward kernel, interpret mode, f32 (atol 1e-5)."""
    f1, f2, g = _grad_inputs(30 + r, r)
    ref1, ref2 = local_correlation_pallas_bwd(jnp.asarray(g), jnp.asarray(f1),
                                              jnp.asarray(f2), r, interpret=True)
    d1, d2 = local_correlation_bwd_plain(torch.from_numpy(g), torch.from_numpy(f1),
                                         torch.from_numpy(f2), r)
    np.testing.assert_allclose(d1.numpy(), np.asarray(ref1), atol=1e-5)
    np.testing.assert_allclose(d2.numpy(), np.asarray(ref2), atol=1e-5)


@pytest.mark.parametrize("r", [1, 2, 5])
def test_autograd_function_matches_plain_autograd(r):
    """The Function's gradients through a concat (the CRE's strided g) vs
    torch autograd of the plain forward (atol 1e-5); one backward call."""
    f1, f2 = _inputs(40 + r)
    ct = torch.from_numpy(np.random.RandomState(r).randn(2, 16, 16, (2 * r + 1) ** 2 + 64)
                          .astype(np.float32))
    grads = []
    for corr in (local_correlation_trainable, local_correlation_plain):
        a = torch.from_numpy(f1).requires_grad_()
        b = torch.from_numpy(f2).requires_grad_()
        (torch.cat([corr(a, b, r), a], dim=-1) * ct).sum().backward()
        grads.append((a.grad.numpy(), b.grad.numpy()))
    for x, y in zip(*grads):
        np.testing.assert_allclose(x, y, atol=1e-5)


def test_bwd_wrapper_sends_cpu_tensors_to_plain_version_and_raises_otherwise():
    f1, f2, g = _grad_inputs(9, 1, (1, 6, 7, 16))
    local_correlation_bwd.launches = 0
    a, b, gt = torch.from_numpy(f1), torch.from_numpy(f2), torch.from_numpy(g)
    for x, y in zip(local_correlation_bwd(gt, a, b, 1),
                    local_correlation_bwd_plain(gt, a, b, 1)):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert local_correlation_bwd.launches == 0
    m = torch.empty((1, 4, 4, 16), device="meta")
    with pytest.raises(ValueError):
        local_correlation_bwd(torch.empty((1, 4, 4, 9), device="meta"), m, m, 1)
