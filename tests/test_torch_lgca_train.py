"""rpnet_tpu_torch's LGCANet_V3 train step (``train/lgca.py``) vs
``rpnet_tpu.train.lgca.make_lgca_train_step``, same weights, in f64 on both
sides (``jax.enable_x64`` as a context, ``model.double()``): in f32 the batch
statistics of a few 32² slices carry each package's rounding far into the
gradient (as for RP_Net, ``test_torch_train_steps.py``).

One step of SGD at lr 1 without momentum history or decay (so the parameter
change is the gradient) on 4 slices of 32², a (1, 8, 16, 16, 1) volume,
``feature_scale`` 8 and 2 ROIs, AttU_Net (every module of U_Net's but the
global feature's place, which the forward tests hold) with BatchNorm2d: the
loss and the 2D Dice within 1e-6 relative, every parameter's gradient and
updated value and every running statistic within 1e-6 of its tensor's
largest magnitude. Weights and sizes: ``test_torch_lgca.py``. The JAX
step's trace and compile in f64 take ~25 s of the test's ~30.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rpnet_tpu.models import lgca as jl
from rpnet_tpu.train.lgca import make_lgca_train_step as jax_make_lgca_train_step
from rpnet_tpu.train.trainer import make_optimizer as jax_make_optimizer
from rpnet_tpu_torch.train.convert import lgca_state_dict_from_jax
from rpnet_tpu_torch.train.lgca import make_lgca_train_step
from rpnet_tpu_torch.train.trainer import make_optimizer

from test_torch_lgca import FS, K, _t, inputs, port_model, random_lgca_variables

torch.set_num_threads(2)   # small shapes; the suite runs several workers on one machine

SGD = {"optimizer": "sgd", "init_lr": 1.0, "momentum": 0.9, "weight_decay": 0.0,
       "scheduler_step": 0}


def _close(a, b, rtol, name):
    """Within ``rtol`` of ``b``'s largest magnitude, or of 1e-9 where that
    is smaller: the biases of the context net's convolutions that an
    instance norm follows have gradients of ~1e-17 in both packages (the
    norm cancels them), which the JAX side reads as a parameter change."""
    np.testing.assert_allclose(a, b, atol=rtol * max(np.abs(b).max(), 1e-9), err_msg=name)


def test_train_step_matches_jax_in_f64():
    volume, slices, mask, vmask = (a.astype(np.float64) for a in inputs(seed=5, b=4))
    model = jl.LGCANetV3(output_ch=K, norm="BatchNorm2d", feature_scale=FS,
                         attention_gates=True)
    variables = random_lgca_variables(model, volume, slices, seed=9)
    with jax.enable_x64(True):
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        opt = jax_make_optimizer(SGD)
        state = {"step": np.int32(0), "params": v["params"], "batch_stats": v["batch_stats"],
                 "opt_state": opt.init(v["params"])}
        step = jax.jit(jax_make_lgca_train_step(model, SGD, opt))
        new, metrics = step(state, tuple(jnp.asarray(a) for a in (volume, slices, mask, vmask)))
        new = jax.tree_util.tree_map(np.asarray, new)
        grads = jax.tree_util.tree_map(lambda a, b: a - b, v["params"], new["params"])
        jloss, jdice = float(metrics["loss"]), float(metrics["unet_dice"])

    port = port_model(variables, True, "BatchNorm2d").double()
    optimizer = make_optimizer(port.parameters(), SGD)
    out = make_lgca_train_step(port, optimizer)({"step": 0}, tuple(
        _t(a) for a in (volume, slices, mask, vmask)))
    np.testing.assert_allclose(float(out["loss"]), jloss, rtol=1e-6)
    np.testing.assert_allclose(float(out["unet_dice"]), jdice, rtol=1e-6)

    ref_grad = lgca_state_dict_from_jax({"params": grads, "batch_stats": new["batch_stats"]})
    ref_new = lgca_state_dict_from_jax({"params": new["params"],
                                        "batch_stats": new["batch_stats"]})
    own = port.state_dict()
    for n, p in port.named_parameters():
        _close(p.grad.numpy(), ref_grad[n].numpy(), 1e-6, f"grad {n}")
        _close(p.detach().numpy(), ref_new[n].numpy(), 1e-6, n)
    stats = [k for k in ref_new if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * (26 + 12)   # the U-Net's batch norms, the gates' 12 included
    for k in stats:
        _close(own[k].numpy(), ref_new[k].numpy(), 1e-6, k)
    before = lgca_state_dict_from_jax(variables)
    assert all(not np.array_equal(own[k].numpy(), before[k].numpy()) for k in stats)
