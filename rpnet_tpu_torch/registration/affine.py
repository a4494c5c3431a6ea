"""Affine registration as a batched Adam fit (net/registration.py:316-357).

The counterpart of ``rpnet_tpu/registration/affine.py``: a 2×3 theta per
slice warps the moving image through ``F.affine_grid`` + ``F.grid_sample``
(both align_corners=False, the torch defaults) and is fitted by ``iters``
Adam steps on the MSE. The S slices of an episode are fitted together: the
loss is the SUM of the per-slice means, so each slice's gradient is its own,
and Adam is elementwise, so each slice follows its own trajectory (the
reference runs one fit per slice, dataset/few_shot_reader.py:122-162).

:func:`fit_affine_plain` is the fit written with autograd: each step's
theta gradient through ``F.affine_grid`` and ``F.grid_sample``, then
:func:`adam_update`. :func:`fit_affine` sends a CPU tensor to the plain
version and a CUDA tensor to the custom op ``rpnet_torch::affine_fit``,
whose CUDA implementation launches the hand-written kernel
``ops/csrc/affine_fit.cu`` (the whole fit in one launch) or raises, and
whose fake implementation gives the output shapes, so ``torch.export`` on
the card records the fit as one node and the served program launches the
kernel. On the card the kernel gives the plain version's theta bit for bit
for two slices or more (cuBLAS reduces a batch of one in another order): it
repeats, in their roundings, the operations autograd runs there (the
kernel's source note lists them), theta's gradient included as the one FMA
chain over the pixels that cuBLAS takes. The fit's trajectory
parts at the slightest difference where a sample coordinate crosses an
integer (ROADMAP queue 3 item 3), so anything short of that would move the
registration off the trajectory the autograd fit takes.
"""

from __future__ import annotations

import torch

from rpnet_tpu_torch.ops.correlation import OP_NAMESPACE
from rpnet_tpu_torch.ops.sampling import affine_grid, grid_sample
from rpnet_tpu_torch.utils.tensor_cache import device_tensor_cache


def affine_warp(x, theta):
    """Warp x (S, H, W, C) by theta (S, 2, 3) → (S, H, W, C)."""
    S, H, W, C = x.shape
    grid = affine_grid(theta, (S, C, H, W), align_corners=False)
    return grid_sample(x, grid, align_corners=False)


ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8   # torch.optim.Adam defaults


def adam_update(param, g, mu, nu, t: int, lr: float):
    """One Adam step (1-based ``t``) in optax's form, as the JAX package
    runs it → (param, mu, nu)."""
    mu = (1 - ADAM_B1) * g + ADAM_B1 * mu
    nu = (1 - ADAM_B2) * g * g + ADAM_B2 * nu
    mu_hat = mu / (1 - ADAM_B1 ** t)
    nu_hat = nu / (1 - ADAM_B2 ** t)
    return param - lr * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)), mu, nu


def base_coords(H: int, W: int, dtype, device):
    """``F.affine_grid``'s base coordinates (align_corners=False) → x (W,)
    and y (H,): its grid of the identity theta, where each is exact."""
    eye = torch.eye(2, 3, dtype=dtype, device=device)[None]
    grid = affine_grid(eye, (1, 1, H, W), align_corners=False)
    return grid[0, 0, :, 0].contiguous(), grid[0, :, 0, 1].contiguous()


_base_coords_cached = device_tensor_cache(base_coords)


def fit_affine_plain(moving, fixed, iters: int = 50, lr: float = 0.01):
    """The fit with autograd: moving/fixed (S, H, W, C) → (theta (S, 2, 3),
    losses (iters, S)); step t's loss is taken at theta before its update,
    the update is :func:`adam_update`."""
    S = moving.shape[0]
    # the identity, made on the device (a tensor from host data would be a
    # copy that blocks the host until the device is idle)
    theta = torch.eye(2, 3, dtype=moving.dtype, device=moving.device).repeat(S, 1, 1)
    mu = torch.zeros_like(theta)
    nu = torch.zeros_like(theta)
    losses = moving.new_empty((iters, S))
    if S == 0:   # F.affine_grid takes no empty batch
        return theta, losses
    with torch.enable_grad():
        for t in range(1, iters + 1):
            th = theta.detach().requires_grad_(True)
            per_slice = torch.mean((fixed - affine_warp(moving, th)) ** 2, dim=(1, 2, 3))
            (g,) = torch.autograd.grad(per_slice.sum(), th)
            losses[t - 1] = per_slice.detach()
            theta, mu, nu = adam_update(theta, g, mu, nu, t, lr)
    return theta.detach(), losses


def check_fit_inputs(moving: torch.Tensor, fixed: torch.Tensor) -> None:
    """Raise unless moving/fixed are what the kernel takes: equal (S, H, W, 1)
    contiguous float32 tensors on one CUDA device."""
    name = "fit_affine"
    if moving.dtype != torch.float32 or fixed.dtype != torch.float32:
        raise ValueError(f"{name}: dtypes {moving.dtype}/{fixed.dtype}; the kernel "
                         "takes float32")
    if moving.dim() != 4 or moving.shape != fixed.shape or moving.shape[-1] != 1:
        raise ValueError(f"{name}: shapes {tuple(moving.shape)} and {tuple(fixed.shape)}; "
                         "the kernel needs equal (S, H, W, 1)")
    if not (moving.is_contiguous() and fixed.is_contiguous()):
        raise ValueError(f"{name}: the kernel needs contiguous tensors")
    if moving.device.type != "cuda" or fixed.device != moving.device:
        raise ValueError(f"{name}: tensors on {moving.device} and {fixed.device}; "
                         "the kernel needs both on one CUDA device")
    from rpnet_tpu_torch.ops import kernels

    S, H, W, _ = moving.shape
    if S > kernels.AFFINE_FIT_MAX_SLICES or max(H, W) > kernels.AFFINE_FIT_MAX_SIDE:
        raise ValueError(f"{name}: {S} slices of {H}×{W}; the kernel takes up to "
                         f"{kernels.AFFINE_FIT_MAX_SLICES} slices of sides up to "
                         f"{kernels.AFFINE_FIT_MAX_SIDE}")


def _fit_affine_cuda(moving: torch.Tensor, fixed: torch.Tensor, iters: int,
                     lr: float):
    check_fit_inputs(moving, fixed)
    from rpnet_tpu_torch.ops import kernels

    S, H, W, _ = moving.shape
    theta = torch.empty((S, 2, 3), dtype=moving.dtype, device=moving.device)
    losses = torch.empty((iters, S), dtype=moving.dtype, device=moving.device)
    if S == 0:
        return theta, losses
    kernels.launch_affine_fit(moving, fixed, *_base_coords_cached(H, W, moving.dtype,
                                                                  moving.device),
                              theta, losses, iters, lr)
    fit_affine.launches += 1
    return theta, losses


_fit_op = torch.library.custom_op(
    f"{OP_NAMESPACE}::affine_fit", _fit_affine_cuda, mutates_args=(), device_types="cuda",
    schema="(Tensor moving, Tensor fixed, int iters, float lr) -> (Tensor, Tensor)")
_fit_op.register_fake(lambda moving, fixed, iters, lr: (
    moving.new_empty((moving.shape[0], 2, 3)), moving.new_empty((iters, moving.shape[0]))))


def fit_affine(moving, fixed, iters: int = 50, lr: float = 0.01):
    """Fit theta by Adam. moving/fixed: (S, H, W, C) → (theta (S, 2, 3),
    losses (iters, S)).

    torch.optim.Adam's defaults and update order (dataset/few_shot_reader.py:148):
    the loss recorded at step i is evaluated at theta_i before the update.
    The update is :func:`adam_update`. CPU tensors take the plain version,
    CUDA tensors the kernel through the custom op (module docstring; counted
    in ``fit_affine.launches``); another device raises.
    """
    for t in (moving, fixed):
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"fit_affine: a tensor on {t.device}; the plain version "
                             "takes CPU tensors, the kernel CUDA tensors")
    if moving.device.type == "cpu":
        return fit_affine_plain(moving, fixed, iters, lr)
    theta, losses = _fit_op(moving, fixed, int(iters), float(lr))
    if torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled():
        # the debug_nans switch (utils/profiling.enable_nan_debugging): the
        # kernel has no backward for anomaly detection to check, as the plain
        # version has, so its outputs are checked as a backward's (waits for
        # the device)
        for k, out in enumerate((theta, losses)):
            if bool(torch.isnan(out).any()):
                raise RuntimeError(f"Function 'fit_affine' returned nan values in its "
                                   f"{k}th output.")
    return theta, losses


fit_affine.launches = 0   # kernel launches (the plain path never counts)
