"""rpnet_tpu_torch's ``n_way: 2`` and ``compute_dtype: bfloat16`` training
vs the JAX trainer: one SGD step on the same weights and batch
(``test_torch_train_breadth.py``'s helpers, shapes and tolerances: loss
1e-4 relative, each tensor's change 10%, running statistics 2e-3 of their
scale). ``n_way: 2`` runs without the align loss (the JAX step goes NaN
with it; see that module). A file of its own so that the suite's workers
split the JAX compiles.
"""

import numpy as np
import torch

from rpnet_tpu_torch.train.convert import state_dict_from_jax

from test_torch_train_breadth import (CASES, H, K, cancelled_biases, changes_close,
                                      check_step, jax_step, make_pair, port_step,
                                      smooth_batch, step_config)

torch.set_num_threads(2)   # small shapes; the suite runs several workers on one machine


def test_n_way_step_matches_jax():
    check_step("n_way2")


def test_bf16_step_matches_jax_and_rounds():
    """``compute_dtype: bfloat16`` against the JAX step, f32 tolerances; and
    the cast shows where f32 noise does not hide it: the running statistics
    of the port's bf16 step agree with the JAX bf16 step's to 1e-5 of their
    scale while the port's f32 step's part from them by more than 1e-3 (the
    step's cast rounds each statistic before its first update), and every
    gradient that reached the f32 master is a bf16 value."""
    kw, extra = CASES["bf16"]
    jmod, variables, port = make_pair(kw)
    cfg = step_config(**extra)
    batch = smooth_batch(2, k=K, size=H)
    start = {k: v.clone() for k, v in port.state_dict().items()}
    jl, jparams, jstats = jax_step(jmod, variables, cfg, batch)
    pl = port_step(port, cfg, batch)
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    changes_close(port, start, jparams, jstats, 0.1, 1e-5, cancelled_biases(port))
    for n, p in port.named_parameters():
        assert torch.equal(p.grad, p.grad.to(torch.bfloat16).float()), n

    f32 = make_pair(kw)[2]
    port_step(f32, step_config(), batch)
    ref = state_dict_from_jax({"params": jparams, "batch_stats": jstats})
    apart = max(float((f32.state_dict()[k] - ref[k]).abs().max() / ref[k].abs().max())
                for k in ref if k.endswith("running_var"))
    assert apart > 1e-3, apart
