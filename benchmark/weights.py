"""The benchmark's weights: drawn from the seed on the device, in two large
calls, under the upstream ``state_dict`` names; the program loads them
through those names and the reference takes the same tensors.

Convolution weights are He-normal (std √(2 / fan_in)), so activations keep
their scale through eval-mode batch norms; convolution biases are
U(±0.05); batch norm scales and running variances U(0.8, 1.2), shifts and
running means U(±0.1).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def draw(template: Dict[str, Tuple[tuple, torch.dtype]], gen: torch.Generator,
         device) -> Dict[str, torch.Tensor]:
    """``template``: name → (shape, dtype) → name → f32 tensor on ``device``
    (integer entries, the batch counters, zeros of their dtype)."""
    norms = {n.rsplit(".", 1)[0] for n in template if n.endswith(".running_mean")}
    conv = [n for n, (s, _) in template.items() if len(s) >= 2]
    rest = [n for n, (s, dt) in template.items() if len(s) < 2 and dt.is_floating_point]
    size = lambda n: math.prod(template[n][0])
    normal = torch.randn(sum(map(size, conv)), generator=gen, device=device)
    uniform = torch.rand(sum(map(size, rest)), generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for n in conv:
        shape = template[n][0]
        out[n] = normal[at:at + size(n)].view(shape) * math.sqrt(2.0 / math.prod(shape[1:]))
        at += size(n)
    at = 0
    for n in rest:
        u = uniform[at:at + size(n)].view(template[n][0])
        at += size(n)
        prefix, leaf = n.rsplit(".", 1)
        if prefix in norms and leaf in ("weight", "running_var"):
            out[n] = 0.8 + 0.4 * u
        elif prefix in norms:
            out[n] = 0.2 * u - 0.1
        else:
            out[n] = 0.1 * u - 0.05
    for n, (shape, dt) in template.items():
        if n not in out:                          # num_batches_tracked
            out[n] = torch.zeros(shape, dtype=dt, device=device)
    return out


def template_of(module) -> Dict[str, Tuple[tuple, torch.dtype]]:
    return {n: (tuple(t.shape), t.dtype) for n, t in module.state_dict().items()}
