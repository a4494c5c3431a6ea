"""NN building blocks on channels-last tensors (net/modules.py).

The port keeps the JAX package's (N, H, W, C) layout at every module
boundary. Convolutions and batch norms view their input as NCHW with
``x.permute(0, 3, 1, 2)``, which for a contiguous NHWC tensor is a
``torch.channels_last`` NCHW tensor: cuDNN's tensor-core algorithms (bf16,
and f32 with TF32, torch's default) run on it without a copy and return
channels-last output, which the inverse permute turns back into a
contiguous NHWC tensor. cuDNN transposes internally where its algorithm
needs NCHW: its f32 algorithms without TF32 (FFT, FFMA implicit GEMM) and
the first convolution's 1-channel input (``nhwcToNchwKernel``; measured in
a training step with ``tools/train_precision_ab.py``). Parameters keep
torch's OIHW layout and the upstream RP-Net ``state_dict`` names
(``conv.0``, ``conv.1``, ``up.1``, ...).

The U-Net's norms are chosen by ``unet_normalize_type``, as the JAX
``Norm2d`` chooses them (``rpnet_tpu/models/blocks.py:62-82``):
:class:`BatchNorm2d`, :class:`InstanceNorm2d` (no parameters) or
:class:`GroupNorm` (8 groups, scale and bias), each in the upstream
``nn.Sequential``'s norm slot (``conv.1``, ``conv.4``, ``up.2``).

BatchNorm in training mode follows the JAX package (flax ``nn.BatchNorm``
under the trainer's episode vmap), not ``torch.nn.BatchNorm2d``: batch
statistics are taken per episode (``groups`` leading blocks of the batch
axis), the running variance takes the biased batch variance, and the new
running statistics are the mean over episodes of the per-episode updates.
Below f32 (the trainer's ``compute_dtype``) the JAX step casts the running
statistics once, as it enters the step: each batch norm's first update of
the step starts from the rounded statistics (``cast_stats``, set by
:func:`cast_statistics` before each step), later ones in f32.

Sharded batches (``train/lgca.sharded_lgca_train_step``): a
:class:`Shards` is one batch split over devices along its first axis, a
tensor per device. The blocks below take one in place of a tensor and run
the shards in lockstep on one host thread, as an SPMD program would: each
op is enqueued for every shard in turn. Parameters stay once, on their
master device; a shard uses ``p.to(shard.device)``, a differentiable copy
(no copy on the master's device), so the shards' gradients sum onto the
master and one optimizer step updates it. :class:`BatchNorm2d` in training
mode takes its statistics over every shard (:meth:`BatchNorm2d.
_forward_shards`). Only the LGCA U-Net takes this path; a tensor input runs
as before.

Initialization: torch's own defaults (Conv2d kaiming_uniform(a=√5), bias
U(±1/√fan_in); BatchNorm2d ones/zeros, running stats 0/1), or kaiming-normal
weights where a conv asks for them (the VGG encoder's), the same
distributions as the JAX package's, drawn from an explicit
``torch.Generator`` by :func:`init_`.
"""

from __future__ import annotations

import itertools
import math

import torch
from torch import nn

from rpnet_tpu_torch.ops.sampling import upsample_nearest2x


class Shards(list):
    """One batch split over devices along its first axis: a tensor per
    shard, each on its own device (see the module doc)."""


def on_shards(fn, *args):
    """``fn(*args)``; where an argument is a :class:`Shards`, ``fn`` once
    per shard, with each Shards argument's shard and the other arguments
    as they are → Shards."""
    n = next((len(a) for a in args if isinstance(a, Shards)), None)
    if n is None:
        return fn(*args)
    return Shards(fn(*(a[i] if isinstance(a, Shards) else a for a in args))
                  for i in range(n))


def replica_call(module: nn.Module, x, *args):
    """``module(x, *args)``; for Shards ``x``, per shard, with the module's
    parameters and buffers copied to the shard's device
    (``torch.func.functional_call``; on the master's device no copy)."""

    def one(xi, *a):
        state = {n: t.to(xi.device) for n, t in itertools.chain(
            module.named_parameters(), module.named_buffers())}
        return torch.func.functional_call(module, state, (xi, *a))

    return on_shards(one, x, *args) if isinstance(x, Shards) else module(x, *args)


class ReLU(nn.ReLU):
    """``nn.ReLU`` that also takes Shards."""

    def forward(self, x):
        return on_shards(super().forward, x)


class Sigmoid(nn.Sigmoid):
    """``nn.Sigmoid`` that also takes Shards."""

    def forward(self, x):
        return on_shards(super().forward, x)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` on (N, H, W, C) tensors.

    Below f32 the bias is added after the convolution's result is rounded,
    as flax's ``nn.Conv`` does (two roundings; a fused bias rounds once and
    differs from it by one ulp on about a quarter of bf16 outputs).
    """

    # tensor parallelism (train/trainer.sharded_train_step): [(device,
    # weight rows)] per slice of the output channels, or None
    tp = None

    def forward(self, x):
        if isinstance(x, Shards):
            return replica_call(self, x)
        if self.tp is not None:
            return self._forward_tp(x)
        return self._conv(x, self.weight, self.bias)

    def _conv(self, x, weight, bias):
        if x.dtype.itemsize < 4 and bias is not None:
            y = self._conv_forward(x.permute(0, 3, 1, 2), weight, None)
            return y.permute(0, 2, 3, 1) + bias.to(x.dtype)
        return self._conv_forward(x.permute(0, 3, 1, 2), weight, bias).permute(0, 2, 3, 1)

    def _forward_tp(self, x):
        """Each slice of the output channels on its device of ``tp`` (the
        input copied there, the bias's rows with it), concatenated on the
        input's device."""
        n = len(self.tp)
        biases = self.bias.chunk(n) if self.bias is not None else [None] * n
        return torch.cat([
            self._conv(x.to(d, non_blocking=True), w,
                       None if b is None else b.to(d)).to(x.device, non_blocking=True)
            for (d, w), b in zip(self.tp, biases)], dim=-1)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (eps 1e-5, momentum 0.1) on (N, H, W, C) tensors.

    In training mode the batch axis holds ``groups`` episodes, episode-major,
    and each episode is normalized with its own statistics, as flax's
    ``nn.BatchNorm(use_running_average=False, momentum=0.9)`` normalizes one
    vmapped episode (``rpnet_tpu/models/blocks.py:62-74``): biased variance
    in f32, ``y = x · scale/√(var+eps) + (bias − mean · scale/√(var+eps))``.
    The running statistics move by ``momentum`` toward the episodes' mean
    batch statistics; since the update is linear, that equals the JAX
    trainer's mean over episodes of the per-episode updates
    (``rpnet_tpu/train/trainer.py:198-203``).

    In eval mode below f32 (the bf16 eval network) it rounds as flax does,
    after each of its three ops; torch's fused eval batch norm rounds once
    and differs from flax by one ulp on about 45% of outputs. f32 eval is
    torch's.
    """

    groups = 1   # episodes in the batch axis (set by RPNet's training forward)
    cast_stats = None   # dtype of the step's cast, until the first update (cast_statistics)

    def forward(self, x):
        if isinstance(x, Shards):
            return self._forward_shards(x) if self.training else replica_call(self, x)
        if not self.training:
            if x.dtype.itemsize < 4:
                # below f32, flax's order and roundings: each op rounds to
                # x.dtype, (x - mean) * (rsqrt(var + eps) * scale) + bias
                dt = x.dtype
                mul = torch.rsqrt(self.running_var.to(dt) + self.eps) * self.weight.to(dt)
                return (x - self.running_mean.to(dt)) * mul + self.bias.to(dt)
            return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        N, H, W, C = x.shape
        xg = x.reshape(self.groups, -1, C)
        stat_dtype = torch.promote_types(x.dtype, torch.float32)
        var, mean = torch.var_mean(xg.to(stat_dtype), dim=1, correction=0)   # (E, C)
        with torch.no_grad():
            cast, self.cast_stats = self.cast_stats, None
            self._update_running(self.running_mean, mean.mean(0), cast)
            self._update_running(self.running_var, var.mean(0), cast)
            self.num_batches_tracked += 1
        mul = self.weight * torch.rsqrt(var + self.eps)                # (E, C)
        shift = self.bias - mean * mul
        y = xg * mul[:, None].to(x.dtype) + shift[:, None].to(x.dtype)
        return y.reshape(N, H, W, C)

    def _forward_shards(self, xs: Shards) -> Shards:
        """Training mode over Shards of one episode: the batch statistics of
        all shards' samples together, as the one-device forward takes them.
        Each shard's f32 channel sums go to the master device; the mean comes
        back, each shard's sum of squared deviations from it goes there too,
        and the variance (biased) comes back with the scale and shift.
        Autograd differentiates the same chain, so the backward reduces the
        two gradient sums across the shards the same way. The running
        statistics update once, from the global statistics."""
        if self.groups != 1:
            raise ValueError("sharded batch norm takes one episode (groups 1), "
                             f"got {self.groups}")
        home = self.weight.device
        stat_dtype = torch.promote_types(xs[0].dtype, torch.float32)
        n = sum(x.numel() // x.shape[-1] for x in xs)
        total = lambda parts: torch.stack([p.to(home) for p in parts]).sum(0)
        mean = total([x.to(stat_dtype).sum((0, 1, 2)) for x in xs]) / n
        var = total([(x.to(stat_dtype) - mean.to(x.device)).square().sum((0, 1, 2))
                     for x in xs]) / n
        with torch.no_grad():
            cast, self.cast_stats = self.cast_stats, None
            self._update_running(self.running_mean, mean, cast)
            self._update_running(self.running_var, var, cast)
            self.num_batches_tracked += 1
        mul = self.weight * torch.rsqrt(var + self.eps)
        shift = self.bias - mean * mul
        return Shards(x * mul.to(x.device, x.dtype) + shift.to(x.device, x.dtype) for x in xs)

    def _update_running(self, running, batch, cast=None):
        """``running`` ← (1 − momentum)·running + momentum·batch. With
        ``cast``, flax's ``momentum * ra`` on the statistic the JAX step cast
        to that dtype (``rpnet_tpu/train/trainer.py:160-162``): the old value
        and the factor rounded to it (0.9 → 0.8984375 in bf16), their product
        and the sum in f32, as XLA computes the jitted step (it keeps the
        product's bf16 rounding out)."""
        m = self.momentum
        if cast is None:
            running.mul_(1 - m).add_(batch, alpha=m)
            return
        decay = float(torch.tensor(1 - m, dtype=cast))
        running.copy_(running.to(cast).to(running.dtype) * decay + m * batch)


class InstanceNorm2d(nn.Module):
    """``unet_normalize_type: InstanceNorm2d`` on (N, H, W, C) tensors:
    torch's default, no affine, eps 1e-5, each sample and channel normalized
    by its own mean and biased variance over H and W, as the JAX ``Norm2d``
    computes it (``rpnet_tpu/models/blocks.py:74-78``). No parameters."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.num_features, self.eps = num_features, eps

    def forward(self, x):
        if isinstance(x, Shards):
            return on_shards(self.forward, x)
        var, mean = torch.var_mean(x, dim=(1, 2), keepdim=True, correction=0)
        return (x - mean) * torch.rsqrt(var + self.eps)


class GroupNorm(nn.GroupNorm):
    """``unet_normalize_type: GroupNorm`` on (N, H, W, C) tensors: flax's
    ``nn.GroupNorm(num_groups=8, epsilon=1e-5)`` (``rpnet_tpu/models/
    blocks.py:79-80``), a per-channel scale and bias (``weight``,
    ``bias``), no running statistics."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(8, num_features, eps=eps)

    def forward(self, x):
        if isinstance(x, Shards):
            return replica_call(self, x)
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


NORMS = {"BatchNorm2d": BatchNorm2d, "InstanceNorm2d": InstanceNorm2d,
         "GroupNorm": GroupNorm}


def set_episode_groups(module: nn.Module, groups: int) -> None:
    """Tell every BatchNorm2d under ``module`` that the batch axis holds
    ``groups`` episodes (training mode)."""
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.groups = groups


def cast_statistics(module: nn.Module, dtype) -> None:
    """Round the running statistics of every BatchNorm2d under ``module`` to
    ``dtype`` where its next update reads them, as the JAX train step's cast
    at its start does."""
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.cast_stats = dtype


class UpsampleNearest2x(nn.Module):
    """``nn.Upsample(scale_factor=2)`` on (N, H, W, C) tensors."""

    def forward(self, x):
        return on_shards(upsample_nearest2x, x)


def conv_bn_relu(cin: int, cout: int, k: int = 3, norm: str = "BatchNorm2d") -> list:
    """[conv k×k "SAME", norm (``NORMS``), ReLU] — the upstream Sequential
    pieces."""
    if norm not in NORMS:
        raise NotImplementedError(f"unet_normalize_type {norm!r}: {', '.join(NORMS)}")
    return [Conv2d(cin, cout, k, padding=k // 2), NORMS[norm](cout), ReLU()]


class ConvBlock(nn.Module):
    """conv3x3+norm+ReLU ×2 (conv_block, net/modules.py:42-58)."""

    def __init__(self, cin: int, cout: int, norm: str = "BatchNorm2d"):
        super().__init__()
        self.conv = nn.Sequential(*conv_bn_relu(cin, cout, norm=norm),
                                  *conv_bn_relu(cout, cout, norm=norm))

    def forward(self, x):
        return self.conv(x)


class UpConv(nn.Module):
    """nearest ×2 upsample + conv3x3 + norm + ReLU (up_conv, net/modules.py:61-75)."""

    def __init__(self, cin: int, cout: int, norm: str = "BatchNorm2d"):
        super().__init__()
        self.up = nn.Sequential(UpsampleNearest2x(), *conv_bn_relu(cin, cout, norm=norm))

    def forward(self, x):
        return self.up(x)


class AttentionBlock(nn.Module):
    """Attention U-Net gate (Attention_block, net/modules.py:78-105; the JAX
    ``AttentionBlock``, ``rpnet_tpu/models/blocks.py:184-199``): ``x`` scaled
    by sigmoid(norm(psi(relu(norm(W_g g) + norm(W_x x))))), each a 1×1 conv
    with bias followed by the ``unet_normalize_type`` norm, under the
    upstream names ``W_g.{0,1}``, ``W_x.{0,1}`` and ``psi.{0,1}``."""

    def __init__(self, f_g: int, f_l: int, f_int: int, norm: str = "BatchNorm2d"):
        super().__init__()
        self.W_g = nn.Sequential(*conv_bn_relu(f_g, f_int, 1, norm)[:2])
        self.W_x = nn.Sequential(*conv_bn_relu(f_l, f_int, 1, norm)[:2])
        self.psi = nn.Sequential(*conv_bn_relu(f_int, 1, 1, norm)[:2], Sigmoid())

    def forward(self, g, x):
        gate = on_shards(lambda a, b: torch.relu(a + b), self.W_g(g), self.W_x(x))
        return on_shards(torch.mul, x, self.psi(gate))


@torch.no_grad()
def init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every conv's parameters (2D and 3D) with torch's default init
    from ``generator`` (reset_parameters draws from the global RNG)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d)):
            if getattr(m, "kaiming_normal", False):   # the VGG encoder's
                nn.init.kaiming_normal_(m.weight, nonlinearity="relu",
                                        generator=generator)
            else:
                nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5),
                                         generator=generator)
            if m.bias is not None:
                fan_in = m.weight[0].numel()
                bound = 1.0 / math.sqrt(fan_in)
                nn.init.uniform_(m.bias, -bound, bound, generator=generator)
    return module
