"""AdamW (decoupled weight decay), as the configurations' ``optimizer:
Adam`` with ``weight_decay`` runs (optax's ``adamw``, ``torch.optim.AdamW``)."""

from __future__ import annotations


def adamw_step(params, grads, state, lr, wd, t, b1=0.9, b2=0.999, eps=1e-8):
    """One update (1-based ``t``) of each tensor of ``params``, in place."""
    for n, p in params.items():
        g = grads[n]
        m, v = state.get(n, (0.0, 0.0))
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        state[n] = (m, v)
        p.mul_(1 - lr * wd)
        p.sub_(lr * (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt() + eps))
