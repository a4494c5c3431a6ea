"""rpnet_tpu_torch.ops.sampling vs rpnet_tpu.ops.sampling on the same
channels-last numpy inputs (f32; atol 1e-5 for sums taken in another order,
exact where both compute the same expression)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpnet_tpu.ops import sampling as J
from rpnet_tpu_torch.ops import sampling as T

torch.set_num_threads(2)   # small shapes; the suite runs several workers on one machine


def _both(fn_j, fn_t, *arrays, **kw):
    out_j = np.asarray(fn_j(*[jnp.asarray(a) for a in arrays], **kw))
    out_t = fn_t(*[torch.from_numpy(a) for a in arrays], **kw).numpy()
    return out_j, out_t


@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample(align_corners):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 11, 3).astype(np.float32)
    grid = (rng.rand(2, 5, 7, 2).astype(np.float32) * 2.6 - 1.3)  # incl. OOB
    j, t = _both(J.grid_sample, T.grid_sample, x, grid, align_corners=align_corners)
    np.testing.assert_allclose(t, j, atol=1e-5)


@pytest.mark.parametrize("align_corners", [False, True])
def test_affine_grid(align_corners):
    theta = np.array([[[1.1, 0.1, -0.2], [0.05, 0.9, 0.3]],
                      [[0.7, -0.3, 0.0], [0.2, 1.2, -0.1]]], np.float32)
    j = np.asarray(J.affine_grid(jnp.asarray(theta), (2, 1, 6, 9), align_corners))
    t = T.affine_grid(torch.from_numpy(theta), (2, 1, 6, 9), align_corners).numpy()
    np.testing.assert_allclose(t, j, atol=1e-6)


def test_compute_grid_keeps_the_s_minus_1_grid():
    j = np.asarray(J.compute_grid((7, 10)))
    t = T.compute_grid((7, 10)).numpy()
    assert t.shape == (1, 2, 7, 10)
    np.testing.assert_allclose(t, j, atol=1e-7)
    np.testing.assert_allclose(t[0, 0, 0, [0, -1]], [-1.0, 1.0])


@pytest.mark.parametrize("src,dst,ac", [(16, 64, False), (64, 16, False),
                                        (5, 9, True), (8, 8, False)])
def test_resize_weights(src, dst, ac):
    np.testing.assert_array_equal(T._resize_weights(src, dst, ac),
                                  J._resize_weights(src, dst, ac))


@pytest.mark.parametrize("size,ac", [((32, 24), False), ((5, 13), True)])
def test_interpolate_bilinear(size, ac):
    x = np.random.RandomState(1).randn(2, 8, 6, 3).astype(np.float32)
    j, t = _both(J.interpolate_bilinear, T.interpolate_bilinear, x, size=size,
                 align_corners=ac)
    np.testing.assert_allclose(t, j, atol=1e-5)


def test_resize_transpose_is_the_adjoint():
    rng = np.random.RandomState(2)
    cot = rng.rand(2, 32, 32, 1).astype(np.float32)
    j, t = _both(J.resize_transpose, T.resize_transpose, cot, src_size=(8, 8))
    np.testing.assert_allclose(t, j, atol=1e-5)
    # <up(x), c> == <x, upᵀ(c)>
    x = torch.from_numpy(rng.rand(2, 8, 8, 1).astype(np.float32))
    c = torch.from_numpy(cot)
    lhs = (T.interpolate_bilinear(x, (32, 32)) * c).sum()
    rhs = (x * T.resize_transpose(c, (8, 8))).sum()
    np.testing.assert_allclose(lhs.item(), rhs.item(), rtol=1e-5)


@pytest.mark.parametrize("name,kw", [("avg_pool2d", dict(kernel=4)),
                                     ("avg_pool2d", dict(kernel=2, stride=2)),
                                     ("max_pool2d", dict(kernel=2, stride=2)),
                                     ("upsample_nearest2x", {})])
def test_pool_and_upsample(name, kw):
    x = np.random.RandomState(3).randn(3, 16, 12, 5).astype(np.float32)
    j, t = _both(getattr(J, name), getattr(T, name), x, **kw)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, atol=1e-6)
