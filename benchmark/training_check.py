"""The comparison of a training cell's first steps with the reference's:
each step's loss, the first gradient as the optimizer got it, the
parameters' change after three steps, and the first step's forward output.

A norm is compared by the gap between the program's norm of a leaf and the
reference's, over the reference's norm of that leaf or of the median leaf,
whichever is larger. The change leaves out leaves whose reference gradient
is under a thousandth of the median leaf's: they move under Adam by
round-off alone (a convolution's bias ahead of a norm)."""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch


class Steps(NamedTuple):
    """What a run of the first steps gave: each step's loss, the first
    gradient by leaf, the parameters after three steps, and the first
    step's forward outputs by name (each a list of tensors)."""
    losses: List[float]
    grads: Dict[str, torch.Tensor]
    params: Dict[str, torch.Tensor]
    outputs: Dict[str, List[torch.Tensor]]


def rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def compare(names, start: Dict[str, torch.Tensor], prog: Steps, ref: Steps):
    """→ (every number, details for the record)."""
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(prog.losses, ref.losses)]
    norm = lambda d: {n: float(d[n].norm()) if n in d else 0.0 for n in names}
    g_ref, g_prog = norm(ref.grads), norm(prog.grads)
    g_med = float(np.median(list(g_ref.values())))
    g_gaps = {n: abs(g_prog[n] - g_ref[n]) / max(g_ref[n], g_med) for n in names}
    moved = [n for n in names if g_ref[n] >= 1e-3 * g_med]
    d_ref = {n: float((ref.params[n] - start[n]).norm()) for n in moved}
    d_prog = {n: float((prog.params[n] - start[n]).norm()) for n in moved}
    d_med = float(np.median(list(d_ref.values())))
    d_gaps = {n: abs(d_prog[n] - d_ref[n]) / max(d_ref[n], d_med) for n in moved}
    numbers = {"loss_gap": max(loss_gaps), "loss1_gap": loss_gaps[0],
               "grad_gap": max(g_gaps.values()),
               "grad_median_gap": float(np.median(list(g_gaps.values()))),
               "change_gap": max(d_gaps.values()),
               "change_median_gap": float(np.median(list(d_gaps.values())))}
    for name, want in ref.outputs.items():
        numbers[f"{name}_rel_err"] = (max(rel(a, b) for a, b in zip(prog.outputs[name], want))
                                      if name in prog.outputs else 0.0)
    top = lambda d: sorted(((round(v, 5), n) for n, v in d.items()), reverse=True)[:3]
    details = {"loss_gaps": loss_gaps, "grad_top": top(g_gaps), "change_top": top(d_gaps),
               "left_out": len(names) - len(moved)}
    return numbers, details
