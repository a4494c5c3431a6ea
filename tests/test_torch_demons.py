"""rpnet_tpu_torch's demons registration vs the JAX package.

Both packages run on the same numpy inputs in f32 on the CPU: smooth
support/query slices with offset organs (``test_torch_registration``), 8
demons steps after 50 affine steps. The port always samples with
``F.grid_sample``; the JAX package's ``sampler="gather"`` has the same values
and subgradients, so:

  * the Gaussian kernels are equal, the blur within 1e-6, the reference's
    ``l2_regulariser_2d`` quirk within 1e-6 relative;
  * ``diffeomorphic_2d`` (4 and 10 squarings) against the JAX gather form
    within 1e-6, ``demons_warp`` against its integration and gather warp
    within 5e-6;
  * the ``gather`` structure against JAX ``register_episode(sampler=
    "gather")`` at fit_scale 1 and 4 (64²): theta within 5e-5 as the
    affine test holds it, the flow within 5e-4 of a flow of ~0.07 (f32
    sums in another order, carried through 8 Adam steps whose first moves
    every entry by ±lr), labels agreeing on more than 99.9% of pixels;
  * the ``matmul`` structure against an oracle composed here from the JAX
    package's public functions with the gather sampler (pool →
    ``fit_demons`` → ``diffeomorphic_2d`` → ``interpolate_bilinear`` →
    warp): the fit's trajectory (losses 1e-5, flow 5e-4), theta 5e-5, the
    integrated result's labels > 99.9%;
  * the ``matmul`` structure against JAX ``register_episode(sampler=
    "matmul")`` at the label and Dice level only: the JAX one-hot sampler's
    subgradient differs at exact-integer coordinates, so the affine
    trajectory differs by design (theta ~1e-2 apart at 64²);
  * the batched fit equals S single-slice fits (it fails if the loss is a
    global NCC over the batch).

The JAX programs compile in 3-6 s each on the CPU (the scaling-and-squaring
integration is unrolled under ``value_and_grad``, and XLA's compile time
grows superlinearly with the squarings: 5.7 s at 4, 3.7 s at 2 on one
structure), so the structure tests integrate with 2 squarings; the
integration itself is held at 4 and 10 above, run op by op.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpnet_tpu.ops import sampling as jsampling
from rpnet_tpu.registration import demons as jdemons
from rpnet_tpu.registration import gaussian as jgaussian
from rpnet_tpu.registration.affine import affine_warp as jax_affine_warp
from rpnet_tpu.registration.affine import fit_affine as jax_fit_affine
from rpnet_tpu.registration.fit import register_episode as jax_register_episode
from rpnet_tpu_torch.core.metrics import dice
from rpnet_tpu_torch.registration import demons, gaussian
from rpnet_tpu_torch.registration.fit import register_episode

from test_torch_registration import registration_inputs

AFFINE, DEMONS, SCALING = 50, 8, 2


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _smooth_flow(S, H, seed, amp=0.05):
    """A smooth flow (S, H, W, 2) of ~``amp`` in normalized coordinates."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:H, :H] / H
    f = [amp * np.sin(2 * np.pi * (a * yy + b * xx) + p)
         for a, b, p in rng.uniform(0.5, 1.5, (S * 2, 3))]
    return np.stack(f).reshape(S, 2, H, H).transpose(0, 2, 3, 1).astype(np.float32)


@pytest.mark.parametrize("sigma,size", [(0.5, 3), (2.0, 9)])
def test_gaussian_kernels_and_blur_match(sigma, size):
    np.testing.assert_array_equal(gaussian.gaussian_kernel_1d(sigma),
                                  jgaussian.gaussian_kernel_1d(sigma))
    k2 = gaussian.gaussian_kernel_2d((sigma, sigma))
    np.testing.assert_array_equal(k2, jgaussian.gaussian_kernel_2d((sigma, sigma)))
    assert k2.shape == (size, size)
    flow = np.random.RandomState(1).randn(3, 20, 24, 2).astype(np.float32)
    ref = np.asarray(jgaussian.gaussian_blur_flow(jnp.asarray(flow), (sigma, sigma)))
    out = gaussian.gaussian_blur_flow(_t(flow), (sigma, sigma)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_l2_regulariser_quirk_matches():
    """The channel difference and the W+1 pad of the reference, per slice."""
    flow = np.random.RandomState(2).randn(3, 12, 10, 2).astype(np.float32)
    flow[..., 1] *= 3.0   # channels differ in scale: a spatial-only form fails
    ref = [float(jgaussian.l2_regulariser_2d(jnp.asarray(f), (1.0, 2.0))) for f in flow]
    out = gaussian.l2_regulariser_2d(_t(flow), (1.0, 2.0)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6)


@pytest.mark.parametrize("scaling", [4, 10])
def test_diffeomorphic_and_warp_match(scaling):
    """Values within 1e-6 (flow) and 5e-6 (a random image with slopes up to
    1 a pixel, sampled at coordinates that torch's CPU grid_sample
    unnormalizes as x·S/2 + (S−1)/2, one rounding away from the JAX form)."""
    H = 32
    flow = _smooth_flow(1, H, seed=scaling)
    img = np.random.RandomState(3).rand(1, H, H, 3).astype(np.float32)
    grid_chw = jsampling.compute_grid((H, H))[0]

    def ref(f, x):
        f_chw = jnp.transpose(f, (2, 0, 1))
        disp = jdemons.diffeomorphic_2d(f_chw, grid_chw, scaling, "gather")
        # demons_warp = the integration, then this warp
        coords = jnp.transpose(grid_chw + disp, (1, 2, 0))[None]
        return jnp.transpose(disp, (1, 2, 0)), jsampling.grid_sample(x[None], coords)[0]

    # op by op: XLA's compile of the unrolled squarings grows superlinearly
    # with their count (~9 s at 10 on the CPU), the eager run takes ~0.3 s
    with jax.disable_jit():
        disp_ref, warped_ref = (np.asarray(a) for a in ref(jnp.asarray(flow[0]),
                                                            jnp.asarray(img[0])))
    grid = demons.identity_grid((H, H))
    disp = demons.diffeomorphic_2d(_t(flow), grid, scaling).numpy()
    warped = demons.demons_warp(_t(img), _t(flow), grid, scaling).numpy()
    assert np.abs(disp - flow).max() > 1e-3     # the integration moved the flow
    np.testing.assert_allclose(disp[0], disp_ref, atol=1e-6)
    np.testing.assert_allclose(warped[0], warped_ref, atol=5e-6)


def _agree(a, b):
    return float(np.mean(np.asarray(a) == np.asarray(b)))


@pytest.fixture(scope="module")
def oracle():
    """The matmul structure at 64², fit_scale 4, composed from the JAX
    package's public functions with the gather sampler."""
    H, s = 64, 4
    s_img, s_lab, q_img = registration_inputs(3, H, seed=3)
    sig = max(0.5, 2.0 / s)
    grid = jsampling.compute_grid((H, H))[0]
    grid_low = jsampling.compute_grid((H // s, H // s))[0]
    pool = lambda a: jsampling.avg_pool2d(a[None], s)[0]
    up = lambda f: jsampling.interpolate_bilinear(jnp.transpose(f, (1, 2, 0))[None], (H, H))[0]

    def one(src, dst, lab):
        src01, dst01 = ((src + 1) * 0.5)[..., None], ((dst + 1) * 0.5)[..., None]
        theta, _ = jax_fit_affine(pool(src01), pool(dst01), iters=AFFINE, sampler="gather")
        both = jax_affine_warp(jnp.concatenate([lab[..., None], src01], -1), theta)
        src_fit, dst_fit = pool(both[..., 1:]), pool(dst01)
        flow_low, losses = jdemons.fit_demons(src_fit, dst_fit, DEMONS, sigma=(sig, sig),
                                              scaling=SCALING, sampler="gather")
        disp = up(jdemons.diffeomorphic_2d(flow_low, grid_low, SCALING, "gather"))
        warped = jsampling.grid_sample(both[None], (jnp.transpose(grid, (1, 2, 0)) + disp)[None])[0]
        return dict(theta=theta, src_fit=src_fit, dst_fit=dst_fit, losses=losses,
                    flow_low=jnp.transpose(flow_low, (1, 2, 0)),
                    warped_label=warped[..., 0] > 0.1, warped_src=warped[..., 1] * 2 - 1)

    ref = jax.jit(jax.vmap(one))(*(jnp.asarray(a) for a in (s_img, q_img, s_lab)))
    return (s_img, s_lab, q_img), {k: np.asarray(v) for k, v in ref.items()}


def test_fit_demons_trajectory_matches(oracle):
    _, ref = oracle
    flow, losses = demons.fit_demons(_t(ref["src_fit"]), _t(ref["dst_fit"]), DEMONS,
                                     sigma=(0.5, 0.5), scaling=SCALING)
    assert losses.shape == (DEMONS, 3) and np.abs(ref["flow_low"]).max() > 1e-2
    np.testing.assert_allclose(losses.numpy(), ref["losses"].T, atol=1e-5)
    np.testing.assert_allclose(flow.numpy(), ref["flow_low"], atol=5e-4)


def test_matmul_structure_matches_oracle(oracle):
    (s_img, s_lab, q_img), ref = oracle
    out = register_episode(_t(s_img), _t(q_img), _t(s_lab), affine_iters=AFFINE,
                           demons_iters=DEMONS, diffeo_scaling=SCALING, fit_scale=4,
                           sampler="matmul")
    np.testing.assert_allclose(out.theta.numpy(), ref["theta"], atol=5e-5)
    np.testing.assert_allclose(out.flow.numpy(), ref["flow_low"].transpose(0, 3, 1, 2),
                               atol=5e-4)
    assert _agree(out.warped_label.numpy(), ref["warped_label"]) > 0.999
    assert _agree(out.warped_label, out.affine_label) < 0.99    # the demons moved it
    np.testing.assert_allclose(out.warped_src.numpy(), ref["warped_src"], atol=2e-3)


@pytest.mark.parametrize("fit_scale,seed", [(1, 0), (4, 1)])
def test_gather_structure_matches_jax(fit_scale, seed):
    """At the affine test's inputs (``test_torch_registration``: 64², seeds 0
    and 1): the affine stage's trajectory is discontinuous at knife-edge
    coordinates, and on other smooth inputs it can part from the JAX one
    before the demons start (ROADMAP queue 3 item 3)."""
    s_img, s_lab, q_img = registration_inputs(3, 64, seed)
    ref = jax_register_episode(jnp.asarray(s_img), jnp.asarray(q_img), jnp.asarray(s_lab),
                               affine_iters=AFFINE, demons_iters=DEMONS,
                               diffeo_scaling=SCALING, fit_scale=fit_scale,
                               sampler="gather")
    out = register_episode(_t(s_img), _t(q_img), _t(s_lab), affine_iters=AFFINE,
                           demons_iters=DEMONS, diffeo_scaling=SCALING,
                           fit_scale=fit_scale, sampler="gather")
    np.testing.assert_allclose(out.theta.numpy(), np.asarray(ref.theta), atol=5e-5)
    assert np.abs(np.asarray(ref.flow)).max() > 1e-2
    np.testing.assert_allclose(out.flow.numpy(), np.asarray(ref.flow), atol=5e-4)
    for name in ("warped_label", "affine_label"):
        assert _agree(getattr(out, name), getattr(ref, name)) > 0.999, name
    assert _agree(out.warped_label, out.affine_label) < 0.99
    np.testing.assert_allclose(out.warped_src.numpy(), np.asarray(ref.warped_src), atol=2e-3)


def test_matmul_structure_matches_jax_at_dice_level():
    H = 64
    s_img, s_lab, q_img = registration_inputs(3, H, seed=5)
    yy, xx = np.mgrid[:H, :H] / H
    ref = jax_register_episode(jnp.asarray(s_img), jnp.asarray(q_img), jnp.asarray(s_lab),
                               affine_iters=AFFINE, demons_iters=DEMONS,
                               diffeo_scaling=SCALING, fit_scale=4, sampler="matmul")
    out = register_episode(_t(s_img), _t(q_img), _t(s_lab), affine_iters=AFFINE,
                           demons_iters=DEMONS, diffeo_scaling=SCALING, fit_scale=4,
                           sampler="matmul")
    # the query's organ, as registration_inputs draws it
    q_lab = np.stack([(((yy - 0.47 - o[2]) / 0.25) ** 2 + ((xx - 0.5 - o[3]) / 0.3) ** 2 <= 1)
                      for o in np.random.RandomState(5).uniform(-0.05, 0.05, (3, 4))])
    q_lab = _t(q_lab.astype(np.float32))
    d_ref = float(dice(_t(np.asarray(ref.warped_label)), q_lab)[0])
    d_out = float(dice(out.warped_label, q_lab)[0])
    assert d_ref > 0.9 and abs(d_out - d_ref) < 5e-3, (d_out, d_ref)
    assert _agree(out.warped_label, ref.warped_label) > 0.99


def test_batched_fit_equals_single_slice_fits():
    """S = 3 slices fitted together give each slice's own fit: the loss is a
    sum of per-slice NCCs (a global NCC over the batch couples them)."""
    s_img, _, q_img = registration_inputs(3, 32, seed=7)
    mov, fix = _t(s_img[..., None] * 0.5 + 0.5), _t(q_img[..., None] * 0.5 + 0.5)
    batched, losses = demons.fit_demons(mov, fix, 6, sigma=(1.0, 1.0), scaling=SCALING)
    for i in range(3):
        one, one_losses = demons.fit_demons(mov[i:i + 1], fix[i:i + 1], 6, sigma=(1.0, 1.0),
                                            scaling=SCALING)
        np.testing.assert_allclose(batched[i:i + 1].numpy(), one.numpy(), atol=1e-6)
        np.testing.assert_allclose(losses[:, i].numpy(), one_losses[:, 0].numpy(), atol=1e-6)
