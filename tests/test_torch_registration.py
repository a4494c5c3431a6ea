"""rpnet_tpu_torch registration and metrics vs the JAX package.

The port's fit runs ``F.grid_sample``; the JAX package's ``sampler="gather"``
mode has the same values AND the same subgradient at exact-integer sample
coordinates (every sample of the identity theta lies on one), so the two Adam
trajectories agree: theta within 5e-5 (docs/PARITY.md:89) after 50 steps,
warped labels equal on more than 99.9% of pixels (a knife-edge pixel at the
0.1 threshold may flip).

The trajectory is discontinuous where a sample coordinate is an exact
integer. Adam's first step moves every theta entry by exactly ±lr, which
lines up such coordinates along diagonals, and torch's CPU grid_sample
unnormalizes as x·S/2 + (S−1)/2, one rounding away from the JAX formula
((x+1)·S − 1)/2; where such a line crosses strong image gradients the two
fits can take opposite one-sided derivatives and part by ~1e-4. The inputs
here are smooth (a soft-edged organ on a low-frequency texture), as CT
slices pooled for the fit are.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpnet_tpu.core.metrics import dice_jax, ncc as jax_ncc
from rpnet_tpu.registration.fit import register_episode as jax_register_episode
from rpnet_tpu_torch.core.metrics import dice, ncc
from rpnet_tpu_torch.registration.fit import register_episode


def registration_inputs(B: int, H: int, seed: int):
    """Smooth support/query slices in [-1, 1] with offset organs; labels."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:H, :H] / H

    def slice_(cy, cx, phase):
        r2 = ((yy - cy) / 0.25) ** 2 + ((xx - cx) / 0.3) ** 2
        soft = 1 / (1 + np.exp(-(1 - r2) / 0.08))
        img = 0.6 * soft - 0.3 + 0.1 * np.sin(2 * np.pi * (2 * yy + xx) + phase)
        return img.astype(np.float32), (r2 <= 1).astype(np.float32)

    off = rng.uniform(-0.05, 0.05, (B, 4))
    supp = [slice_(0.5 + o[0], 0.45 + o[1], 0.0) for o in off]
    qry = [slice_(0.47 + o[2], 0.5 + o[3], 0.3) for o in off]
    return (np.stack([s[0] for s in supp]), np.stack([s[1] for s in supp]),
            np.stack([q[0] for q in qry]))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fit_scale", [1, 4])
def test_register_episode_matches_gather_mode(fit_scale, seed):
    s_img, s_lab, q_img = registration_inputs(3, 64, seed)
    ref = jax_register_episode(jnp.asarray(s_img), jnp.asarray(q_img),
                               jnp.asarray(s_lab), affine_iters=50,
                               demons_iters=0, fit_scale=fit_scale,
                               sampler="gather")
    out = register_episode(torch.from_numpy(s_img), torch.from_numpy(q_img),
                           torch.from_numpy(s_lab), affine_iters=50,
                           fit_scale=fit_scale)
    theta = out.theta.numpy()
    assert np.abs(theta - np.eye(2, 3)).max() > 1e-3     # the fit moved
    assert out.flow is None                              # no demons steps
    np.testing.assert_allclose(theta, np.asarray(ref.theta), atol=5e-5)
    for name in ("warped_label", "affine_label"):
        agree = np.mean(getattr(out, name).numpy() == np.asarray(getattr(ref, name)))
        assert agree > 0.999, (name, agree)
    # images: a theta difference within 5e-5 moves a sample by up to
    # 5e-5 × 32 px on a slope below 1 per pixel
    for name in ("warped_src", "affine_src"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=2e-3)


def test_dice_and_ncc_match():
    rng = np.random.RandomState(5)
    pred = (rng.rand(4, 16, 16) > 0.5).astype(np.float32)
    target = (rng.rand(4, 16, 16) > 0.4).astype(np.float32)
    w = np.array([1, 1, 0, 1], np.float32)
    for weight in (None, w):
        d_ref, v_ref = dice_jax(jnp.asarray(pred), jnp.asarray(target),
                                weight=None if weight is None else jnp.asarray(weight))
        d, v = dice(torch.from_numpy(pred), torch.from_numpy(target),
                    weight=None if weight is None else torch.from_numpy(weight))
        np.testing.assert_allclose(d.item(), float(d_ref), rtol=1e-6)
        assert bool(v) == bool(v_ref)
    _, valid = dice(torch.from_numpy(pred), torch.zeros(4, 16, 16))
    assert not bool(valid)

    a = rng.randn(4, 16, 16).astype(np.float32)
    b = (a + 0.5 * rng.randn(4, 16, 16)).astype(np.float32)
    for weight in (None, w[:, None, None]):
        ref = jax_ncc(jnp.asarray(a), jnp.asarray(b),
                      weight=None if weight is None else jnp.asarray(weight))
        out = ncc(torch.from_numpy(a), torch.from_numpy(b),
                  weight=None if weight is None else torch.from_numpy(weight))
        np.testing.assert_allclose(out.item(), float(ref), rtol=1e-5)
    # per slice (the demons loss): the JAX global NCC of each slice alone
    per_slice = ncc(torch.from_numpy(a), torch.from_numpy(b), dims=(1, 2)).numpy()
    ref = [float(jax_ncc(jnp.asarray(x), jnp.asarray(y))) for x, y in zip(a, b)]
    np.testing.assert_allclose(per_slice, ref, rtol=1e-5)


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_deeds_fit_matches_jax(mode):
    """DEEDS (``registration/deeds.py``) on 2 slices at 48², a 24² control
    grid and 7² candidate shifts: the sample grid within 1e-5 of the JAX
    package's per-slice one (pools and a softmax in f32), its warp within
    1e-4. The affine + DEEDS pair with 10 affine steps: theta is the port's
    ``fit_affine`` (held above; the JAX ``affine_deeds_fit`` fits with its
    default matmul sampler, another trajectory by design), the grid and the
    combined warp against the JAX functions at that theta."""
    from functools import partial

    from rpnet_tpu.registration import deeds as jdeeds
    from rpnet_tpu.registration.affine import affine_warp as jax_affine_warp
    from rpnet_tpu_torch.registration import deeds
    from rpnet_tpu_torch.registration.affine import fit_affine

    s_img, _, q_img = registration_inputs(2, 48, seed=4)
    mov, fix = s_img[..., None] * 0.5 + 0.5, q_img[..., None] * 0.5 + 0.5
    kw = dict(grid_size=24, disp_range=0.1, displacement_width=7, mode=mode)
    jfit = jax.jit(jax.vmap(partial(jdeeds.deeds_fit, **kw)))
    ref = np.asarray(jfit(jnp.asarray(mov), jnp.asarray(fix)))
    out = deeds.deeds_fit(torch.from_numpy(mov), torch.from_numpy(fix), **kw)
    same = deeds.deeds_fit(torch.from_numpy(fix), torch.from_numpy(fix), **kw)
    assert out.shape == ref.shape == (2, 48, 48, 2)
    assert (out - same).abs().max() > 1e-3      # the grid follows the image
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    warped = deeds.deeds_warp(torch.from_numpy(mov), out).numpy()
    ref_w = jax.vmap(jdeeds.deeds_warp)(jnp.asarray(mov), jnp.asarray(ref))
    np.testing.assert_allclose(warped, np.asarray(ref_w), atol=1e-4)

    theta, grid = deeds.affine_deeds_fit(torch.from_numpy(mov), torch.from_numpy(fix),
                                         affine_iters=10, **kw)
    assert torch.equal(theta, fit_affine(torch.from_numpy(mov), torch.from_numpy(fix),
                                         iters=10)[0])
    th = jnp.asarray(theta.numpy())
    jgrid = jfit(jax.vmap(jax_affine_warp)(jnp.asarray(mov), th), jnp.asarray(fix))
    np.testing.assert_allclose(grid.numpy(), np.asarray(jgrid), atol=1e-4)
    np.testing.assert_allclose(
        deeds.affine_deeds_warp(torch.from_numpy(mov), theta, grid).numpy(),
        np.asarray(jax.vmap(jdeeds.affine_deeds_warp)(jnp.asarray(mov), th,
                                                      jnp.asarray(grid.numpy()))),
        atol=1e-4)
