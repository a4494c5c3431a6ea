"""A cache for small constant tensors made on the device.

Constant matrices and kernels (the bilinear resize matrices, the Gaussian
blur kernels) are made once a (shape, device, dtype): a fresh copy from host
memory on each call would block the host until the device is idle. While
``torch.export`` traces (a fake-tensor mode is active) the tensor made is a
fake one, which must never reach a live call, so the cache is bypassed
there and the trace records the constant it made.
"""

from __future__ import annotations

import functools

import torch
import torch._guards


def device_tensor_cache(fn):
    """``functools.lru_cache`` of ``fn``, bypassed while tracing."""
    cached = functools.lru_cache(maxsize=None)(fn)

    @functools.wraps(fn)
    def wrapper(*args):
        if torch._guards.detect_fake_mode() is not None:
            return fn(*args)
        return cached(*args)

    wrapper.cache_clear = cached.cache_clear
    wrapper.cache_info = cached.cache_info
    return wrapper
