"""The affine fit's kernel arithmetic (``ops/csrc/affine_fit.cu``) and its
wrapper's rules, on the CPU.

The kernel runs only on the card, where ``chip_smoke.py`` phase
``affine-fit`` holds its theta bit for bit to the plain version
(``registration/affine.fit_affine_plain``, the fit through autograd) for
two slices or more. Here :func:`closed_form_step` writes out, in PyTorch,
the step the kernel computes: the grid point as ``F.affine_grid``'s bmm rounds it, the bilinear
taps and the grid gradient as ``F.grid_sample`` accumulates them, the MSE's
gradient, and theta's gradient as one FMA chain over the pixels (cuBLAS's
order on the card; a fused multiply-add is taken in f64, exact before its
one rounding but in rare ties). It is held against autograd through
``F.affine_grid`` + ``F.grid_sample`` on the CPU, whose kernels round
otherwise: the loss within 1e-6 and the gradient within 1e-5 relative; and
fifty such steps with ``adam_update`` against the plain fit, theta within
5e-5.

The gradient jumps where a sample coordinate crosses an integer (the
derivative is floor-based, one-sided at an exact integer). Torch's CPU
``grid_sample`` unnormalizes as x·S/2 + (S−1)/2, one rounding away from
((x+1)·S − 1)/2 (ROADMAP queue 3 item 3), so in f32 a generic theta that
sweeps many pixels across integers can put a pixel on the other side in the
two formulas; that case is compared in f64, where only exact integers are
knife edges. The identity theta, whose every sample lies on an exact
integer, is compared in both dtypes.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rpnet_tpu_torch.ops import kernels
from rpnet_tpu_torch.ops.sampling import affine_grid
from rpnet_tpu_torch.registration import affine
from rpnet_tpu_torch.registration.affine import (adam_update, affine_warp, base_coords,
                                                 check_fit_inputs, fit_affine, fit_affine_plain)

torch.set_num_threads(2)   # small shapes; the suite runs several workers on one machine

THETAS = {
    "identity": [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
    # a near-identity theta: every sample inside, none on an integer
    "inside": [[0.93, -0.07, 0.031], [0.05, 1.04, -0.02]],
    # scaled, sheared and shifted: most samples outside (zero padding)
    "outside": [[1.1, 0.2, 0.5], [-0.1, 0.9, -0.7]],
}


def smooth_slices(S: int, H: int, seed: int):
    """Moving/fixed (S, H, H, 1) in [0, 1]: a soft-edged organ on a
    low-frequency texture, offset between the two (the kind of
    ``tests/test_torch_registration.registration_inputs``)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:H, :H] / H

    def slice_(cy, cx, phase):
        r2 = ((yy - cy) / 0.25) ** 2 + ((xx - cx) / 0.3) ** 2
        soft = 1 / (1 + np.exp(-(1 - r2) / 0.08))
        return 0.5 + 0.3 * soft - 0.15 + 0.05 * np.sin(2 * np.pi * (2 * yy + xx) + phase)

    off = rng.uniform(-0.05, 0.05, (S, 4))
    mov = np.stack([slice_(0.5 + o[0], 0.45 + o[1], 0.0) for o in off])
    fix = np.stack([slice_(0.47 + o[2], 0.5 + o[3], 0.3) for o in off])
    return (torch.from_numpy(mov[..., None].astype(np.float32)),
            torch.from_numpy(fix[..., None].astype(np.float32)))


def _fma(a, b, c):
    """a·b + c rounded once to a's dtype (f32 through f64; f64 as is)."""
    if a.dtype == torch.float64:
        return a * b + c
    return (a.double() * b.double() + c.double()).to(a.dtype)


def closed_form_step(moving, fixed, theta, chain: bool = True):
    """One step of the kernel in PyTorch: moving/fixed (S, H, W, 1), theta
    (S, 2, 3) → (loss (S,), theta's gradient (S, 2, 3)). ``chain``: theta's
    gradient as the kernel's FMA chain over the pixels in order (a Python
    loop), else as exact sums."""
    S, H, W, _ = moving.shape
    dt = moving.dtype
    xn, yn = base_coords(H, W, dt, moving.device)
    xn, yn = xn[None, None, :].expand(S, H, W), yn[None, :, None].expand(S, H, W)
    t = theta[:, :, :, None, None]
    gx = _fma(yn, t[:, 0, 1].expand(S, H, W), xn * t[:, 0, 0]) + t[:, 0, 2]
    gy = _fma(yn, t[:, 1, 1].expand(S, H, W), xn * t[:, 1, 0]) + t[:, 1, 2]
    ix = _fma(gx + 1.0, torch.full_like(gx, W), torch.full_like(gx, -1.0)) * 0.5
    iy = _fma(gy + 1.0, torch.full_like(gy, H), torch.full_like(gy, -1.0)) * 0.5
    x0, y0 = torch.floor(ix), torch.floor(iy)
    wx0, wx1 = (x0 + 1.0) - ix, ix - x0
    wy0, wy1 = (y0 + 1.0) - iy, iy - y0
    flat = moving[..., 0].reshape(S, H * W)

    def tap(yy, xx):   # the moving image at integer (yy, xx) and whether it is inside
        inside = (xx >= 0) & (xx <= W - 1) & (yy >= 0) & (yy <= H - 1)
        idx = torch.where(inside, yy * W + xx, 0.0).long().reshape(S, H * W)
        return torch.where(inside, torch.gather(flat, 1, idx).reshape(S, H, W), 0.0), inside

    taps = [tap(y0, x0), tap(y0, x0 + 1.0), tap(y0 + 1.0, x0), tap(y0 + 1.0, x0 + 1.0)]
    zero = torch.zeros_like(gx)
    w = zero
    for (v, inside), wt in zip(taps, (wx0 * wy0, wx1 * wy0, wx0 * wy1, wx1 * wy1)):
        w = torch.where(inside, _fma(v, wt, w), w)
    d = fixed[..., 0] - w
    gout = -((1.0 / (H * W)) * (2.0 * d))
    gix, giy = zero, zero
    for (v, inside), sx, wtx, sy, wty in zip(taps, (-1, 1, -1, 1), (wy0, wy0, wy1, wy1),
                                             (-1, -1, 1, 1), (wx0, wx1, wx0, wx1)):
        gix = torch.where(inside, _fma(sx * (v * wtx), gout, gix), gix)
        giy = torch.where(inside, _fma(sy * (v * wty), gout, giy), giy)
    grads = ((W / 2) * gix, (H / 2) * giy)
    bases = (xn, yn, torch.ones_like(xn))
    g = torch.empty((S, 2, 3), dtype=dt)
    for r in range(2):
        for k in range(3):
            prods = (bases[k].double() * grads[r].double()).reshape(S, -1).numpy()
            if not chain:
                g[:, r, k] = torch.from_numpy(prods.sum(1)).to(dt)
                continue
            for s in range(S):
                acc = np.float64(0.0)
                for p in prods[s]:
                    acc = np.float64(dt_np(dt)(p + acc))
                g[s, r, k] = float(acc)
    loss = (d.double() ** 2).sum((1, 2)).to(dt) / (H * W)
    return loss, g


def dt_np(dt):
    return np.float32 if dt == torch.float32 else np.float64


def autograd_step(moving, fixed, theta):
    """A step's per-slice loss and theta's gradient by autograd through
    ``F.affine_grid`` + ``F.grid_sample`` (the plain version's step)."""
    th = theta.detach().requires_grad_(True)
    with torch.enable_grad():
        per_slice = torch.mean((fixed - affine_warp(moving, th)) ** 2, dim=(1, 2, 3))
        (g,) = torch.autograd.grad(per_slice.sum(), th)
    return per_slice.detach(), g


@pytest.mark.parametrize("name,dtype", [("identity", torch.float32),
                                        ("identity", torch.float64),
                                        ("inside", torch.float32),
                                        ("outside", torch.float64)])
def test_closed_form_step_matches_autograd(name, dtype):
    mov, fix = (t.to(dtype) for t in smooth_slices(2, 32, seed=0))
    theta = torch.tensor(THETAS[name], dtype=dtype).repeat(2, 1, 1)
    loss_ref, g_ref = autograd_step(mov, fix, theta)
    loss, g = closed_form_step(mov, fix, theta)
    assert loss.dtype == g.dtype == dtype and g.shape == (2, 2, 3)
    np.testing.assert_allclose(loss.numpy(), loss_ref.numpy(), rtol=1e-6)
    scale = float(g_ref.abs().max())
    assert scale > 1e-4                                  # a gradient to compare
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=1e-5, atol=1e-5 * scale)
    if name == "outside":   # most samples fall outside the image
        grid = affine_grid(theta, (2, 1, 32, 32), align_corners=False)
        assert float((grid.abs() > 1).any(-1).float().mean()) > 0.5


@pytest.mark.parametrize("seed", [0, 1])
def test_closed_form_fit_matches_the_plain_fit(seed):
    """Fifty closed-form steps (sums exact, not chained: the chain is a
    Python loop) with ``adam_update`` against the plain fit."""
    mov, fix = smooth_slices(3, 64, seed)
    theta = torch.eye(2, 3).repeat(3, 1, 1)
    mu, nu, losses = torch.zeros_like(theta), torch.zeros_like(theta), []
    for t in range(1, 51):
        loss, g = closed_form_step(mov, fix, theta, chain=False)
        losses.append(loss)
        theta, mu, nu = adam_update(theta, g, mu, nu, t, 0.01)
    theta_ref, losses_ref = fit_affine_plain(mov, fix)
    assert theta_ref.shape == (3, 2, 3) and losses_ref.shape == (50, 3)
    assert float((theta_ref - torch.eye(2, 3)).abs().max()) > 1e-2    # the fit moved
    np.testing.assert_allclose(theta.numpy(), theta_ref.numpy(), atol=5e-5)
    np.testing.assert_allclose(torch.stack(losses).numpy(), losses_ref.numpy(), rtol=1e-4)
    assert float(losses_ref[-1].max()) < float(losses_ref[0].min())    # and fitted


def test_cpu_tensors_take_the_plain_version_and_never_count_a_launch():
    mov, fix = smooth_slices(2, 32, seed=3)
    fit_affine.launches = 0
    theta, losses = fit_affine(mov, fix, iters=10)
    ref_theta, ref_losses = fit_affine_plain(mov, fix, iters=10)
    assert torch.equal(theta, ref_theta) and torch.equal(losses, ref_losses)
    empty_theta, empty_losses = fit_affine(mov[:0], fix[:0], iters=10)
    assert empty_theta.shape == (0, 2, 3) and empty_losses.shape == (10, 0)
    assert fit_affine.launches == 0


def _bad(kind):
    mov, fix = smooth_slices(2, 16, seed=4)
    if kind == "channels":
        return torch.cat([mov, mov], -1), torch.cat([fix, fix], -1), "equal \\(S, H, W, 1\\)"
    if kind == "float64":
        return mov.double(), fix.double(), "float32"
    if kind == "non-contiguous":
        return mov.transpose(1, 2), fix.transpose(1, 2), "contiguous"
    return mov.to("meta"), fix.to("meta"), "CUDA"


@pytest.mark.parametrize("kind", ["channels", "float64", "non-contiguous", "meta"])
def test_wrapper_raises_for_what_the_kernel_cannot_take(kind):
    """The kernel's checks raise for C ≠ 1, f64, a non-contiguous input and a
    tensor off the card; a meta tensor takes neither the plain version nor
    the fake one (``fit_affine`` refuses it before the op)."""
    mov, fix, match = _bad(kind)
    with pytest.raises(ValueError, match=match):
        check_fit_inputs(mov, fix)
    if kind == "meta":
        with pytest.raises(ValueError, match="CUDA tensors"):
            fit_affine(mov, fix)
    # a CPU float32 (S, H, W, 1) input passes every check but the device's
    good_mov, good_fix = smooth_slices(2, 16, seed=4)
    with pytest.raises(ValueError, match="one CUDA device"):
        check_fit_inputs(good_mov, good_fix)


def test_custom_op_schema_and_fake_implementation():
    """``rpnet_torch::affine_fit``: its schema, and the fake implementation's
    shapes and dtype (what ``torch.export`` records on the card)."""
    op = torch.ops.rpnet_torch.affine_fit.default
    assert str(op._schema) == ("rpnet_torch::affine_fit(Tensor moving, Tensor fixed, "
                               "int iters, float lr) -> (Tensor, Tensor)")
    mov = torch.empty((3, 16, 16, 1), device="meta")
    theta, losses = op(mov, mov, 4, 0.01)
    assert (tuple(theta.shape), tuple(losses.shape), theta.dtype) == \
        ((3, 2, 3), (4, 3), torch.float32)


def test_kernel_limits_agree_with_the_source():
    """``ops/kernels.py`` repeats the kernel's limits, which the wrapper
    checks before it builds anything."""
    src = (Path(affine.__file__).resolve().parents[1] / "ops" / "csrc" /
           "affine_fit.cu").read_text()
    limits = dict(re.findall(r"constexpr int (MAX_SLICES|MAX_SIDE) = (\d+);", src))
    assert int(limits["MAX_SLICES"]) == kernels.AFFINE_FIT_MAX_SLICES
    assert int(limits["MAX_SIDE"]) == kernels.AFFINE_FIT_MAX_SIDE
