"""rpnet_tpu_torch train steps vs ``rpnet_tpu.train.trainer.make_train_step``
beyond one SGD update (helpers and shapes: ``test_torch_train.py``), f32:

  * the step's loss gradient in f64 (where the JAX package's own f32
    gradient error is out of the way);
  * three AdamW updates crossing one learning-rate decay;
  * one step with the registration prior inside it (8 affine Adam steps,
    ``reg_sampler: gather``, smooth inputs; ROADMAP queue 3 explains why
    the fits are compared on smooth inputs only).

The loss at these tiny batches is steep (one Adam step at lr 1e-4 takes it
from 1.6 to 0.65), so a step amplifies the JAX package's few-percent f32
gradient error (``test_sgd_step_matches``) into the next loss; the AdamW
steps therefore run at lr 1e-6, where both packages' losses agree to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np

from rpnet_tpu_torch.train.convert import state_dict_from_jax
from rpnet_tpu_torch.train.trainer import make_optimizer, make_train_step

from test_torch_train import (_config, _jax_model, _port_model, _stats_close,
                              _t, param_change_close, run_both, smooth_batch,
                              weights)  # noqa: F401


def test_gradients_match_in_f64(weights):
    """The train step's loss (dice_ce + align loss, mean over episodes) and
    its gradient in f64 on both sides: ``jax.grad`` of the JAX model's
    training forward vmapped over episodes (as ``make_train_step`` builds
    it) vs the port's autograd, every parameter within 1e-5 of its tensor's
    largest gradient."""
    from rpnet_tpu.models.losses import dice_ce as jax_dice_ce

    s_img, s_lab, q_img, q_lab = (a.astype(np.float64) for a in smooth_batch(7))
    with jax.enable_x64(True):
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), weights)
        model = _jax_model()

        def loss(params):
            def episode(si, sl, qi, ql):
                fore = sl[None, None]
                out, _ = model.apply({"params": params, "batch_stats": v["batch_stats"]},
                                     si[None, None, ..., None], fore, 1.0 - fore,
                                     qi[..., None], sl, train=True,
                                     mutable=["batch_stats"])
                return jax_dice_ce(out["output"], ql.astype(jnp.int32)) + out["align_loss"]
            return jnp.mean(jax.vmap(episode)(*(jnp.asarray(a) for a in
                                                (s_img[:, 0], s_lab[:, 0], q_img, q_lab))))

        jloss, grads = jax.jit(jax.value_and_grad(loss))(v["params"])
        ref = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, grads),
                                   "batch_stats": weights["batch_stats"]})
    port = _port_model(weights).double()
    step = make_train_step(port, _config(optimizer="sgd", init_lr=0.0), make_optimizer(
        port.parameters(), _config(optimizer="sgd", init_lr=0.0)))
    metrics = step({"step": 0}, tuple(_t(a) for a in (s_img, s_lab, q_img, q_lab)))
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=1e-6)
    for n, p in port.named_parameters():
        g = p.grad.numpy()
        np.testing.assert_allclose(g, ref[n].numpy(), atol=1e-5 * np.abs(ref[n].numpy()).max() + 1e-12,
                                   err_msg=n)




def test_adamw_steps_across_decay_match(weights):
    """lr 1e-6, ×0.1 after the second update (scheduler_step 1 epoch of 2
    updates): losses to 1e-4 relative, running statistics to 2e-3 of their
    scale. The update rule itself is held exactly by
    ``test_optimizer_matches_optax``."""
    cfg = _config(optimizer="Adam", init_lr=1e-6, scheduler_step=1)
    batches = [smooth_batch(s) for s in (3, 4, 5)]
    jl, jstate, pl, port = run_both(weights, cfg, batches, steps_per_epoch=2)
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    _stats_close(port, jstate["batch_stats"], jstate["params"], 2e-3)


def test_step_with_registration_matches(weights):
    """Loss to 1e-4 relative and running statistics as in
    ``test_sgd_step_matches``; each tensor's change to 20% (the f32 gradient
    error of that test, plus the prior: two 8-step affine fits in f32 whose
    > 0.1 label threshold can part on a pixel)."""
    cfg = _config(optimizer="sgd", init_lr=1.0, use_registration_loss=True)
    jl, jstate, pl, port = run_both(weights, cfg, [smooth_batch(6)])
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    param_change_close(port, jstate["params"], weights, 0.2)
    _stats_close(port, jstate["batch_stats"], jstate["params"], 2e-3)
