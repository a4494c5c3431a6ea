"""rpnet_tpu_torch training vs the JAX package, with the same weights.

Everything runs in f32 on the CPU on the same numpy inputs, weights carried
by ``state_dict_from_jax``, at E=2 episodes of k=2 slices, 32², U-Net d4,
2 refinement iterations:

  * train-mode BatchNorm against flax ``nn.BatchNorm`` vmapped over episodes
    (outputs 1e-5, running statistics 1e-6: f32 sums in another order);
  * the RPNet training forward against ``model.apply(train=True,
    mutable=["batch_stats"])`` vmapped over episodes (refinement logits,
    about 16 in magnitude, 5e-3: batch statistics of two 32² slices — eight
    values per channel at the U-Net's deepest level — carry f32 differences
    further than the eval forward's running statistics, whose tests hold
    2e-3; align loss 1e-4; running statistics 1e-4 of their scale);
  * one train step against ``rpnet_tpu.train.trainer.make_train_step``
    with SGD at lr 1 (the parameter change is the gradient), r = 1 and 2;
  * ``make_optimizer`` against the JAX package's on the same gradients.

``test_torch_train_steps.py`` adds the f64 gradient, AdamW steps across a
decay and a step with the registration prior.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from rpnet_tpu.models.rpnet import RPNet as JaxRPNet
from rpnet_tpu.train.trainer import make_optimizer as jax_make_optimizer
from rpnet_tpu.train.trainer import make_train_step as jax_make_train_step
from rpnet_tpu_torch.models.blocks import BatchNorm2d
from rpnet_tpu_torch.models.rpnet import RPNet
from rpnet_tpu_torch.train.convert import state_dict_from_jax
from rpnet_tpu_torch.train.trainer import make_optimizer, make_train_step

from test_torch_models import jax_rpnet

torch.set_num_threads(2)   # small shapes; the suite runs several workers on one machine

E, K, H, R, T = 2, 2, 32, 2, 2


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("groups", [1, 3])
def test_batchnorm_train_matches_flax(groups):
    rng = np.random.RandomState(groups)
    x = (rng.randn(groups, 4, 5, 6, 8) * 2 + 1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.normal(0, 0.1, 8).astype(np.float32)
    mean0 = rng.normal(0, 0.1, 8).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    ys, stats = jax.vmap(lambda a: bn.apply(variables, a, mutable=["batch_stats"]))(x)
    ref_mean = np.asarray(stats["batch_stats"]["mean"]).mean(0)
    ref_var = np.asarray(stats["batch_stats"]["var"]).mean(0)

    port = BatchNorm2d(8).train()
    port.groups = groups
    with torch.no_grad():
        port.weight.copy_(_t(scale))
        port.bias.copy_(_t(bias))
        port.running_mean.copy_(_t(mean0))
        port.running_var.copy_(_t(var0))
    out = port(_t(x.reshape(-1, 5, 6, 8)))
    np.testing.assert_allclose(out.detach().numpy().reshape(x.shape), np.asarray(ys),
                               atol=1e-5)
    np.testing.assert_allclose(port.running_mean.numpy(), ref_mean, atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(), ref_var, atol=1e-6)


def smooth_batch(seed: int, k: int = K, size: int = H):
    """(supp_img, supp_lab, qry_img, qry_lab): E episodes of k slices, smooth
    images in [-1, 1] with a shifted elliptic organ."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:size, :size] / size
    s_img, s_lab, q_img, q_lab = [], [], [], []
    for _ in range(E * k):
        cy, cx, dy, dx = rng.uniform(0.4, 0.6, 2).tolist() + rng.uniform(-0.06, 0.06, 2).tolist()
        for imgs, labs, (oy, ox) in ((s_img, s_lab, (cy, cx)), (q_img, q_lab, (cy + dy, cx + dx))):
            r2 = ((yy - oy) / 0.22) ** 2 + ((xx - ox) / 0.28) ** 2
            labs.append((r2 <= 1).astype(np.float32))
            imgs.append((0.8 * np.exp(-r2) - 0.4 + 0.01 * rng.randn(size, size))
                        .astype(np.float32))
    shape = (E, 1, k, size, size)
    return (np.stack(s_img).reshape(shape), np.stack(s_lab).reshape(shape),
            np.stack(q_img).reshape(shape[:1] + shape[2:]),
            np.stack(q_lab).reshape(shape[:1] + shape[2:]))


@pytest.fixture(scope="module")
def weights():
    _, variables = jax_rpnet(radius=R, num_iter=T, size=H, seed=5)
    return variables


def with_radius(variables, r: int):
    """``variables`` for a CRE of radius ``r``: the same weights, the q
    conv's kernel over the correlation cut to its first (2r+1)² input
    channels (no second JAX init to compile)."""
    out = jax.tree_util.tree_map(np.array, variables)
    q = out["params"]["cre"]["q_conv_corr"]["conv"]
    q["kernel"] = np.ascontiguousarray(q["kernel"][:, :, :(2 * r + 1) ** 2])
    return out


def _jax_model(num_iter=T, soft_mask=True, radius=R):
    return JaxRPNet(backbone="UNet", num_iter=num_iter, radius=radius, align=True,
                    soft_mask=soft_mask)


def _port_model(variables, num_iter=T, soft_mask=True, radius=R):
    port = RPNet(radius=radius, num_iter=num_iter, align=True, soft_mask=soft_mask)
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    return port.train()


def _stats_close(port, jax_stats, params, rtol):
    """Running statistics of the port vs a JAX batch_stats tree, each tensor
    within ``rtol`` of its largest magnitude."""
    ref = state_dict_from_jax({"params": params, "batch_stats": jax_stats})
    own = port.state_dict()
    names = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * 19   # 19 batch norms
    for k in names:
        a, b = own[k].numpy(), ref[k].numpy()
        np.testing.assert_allclose(a, b, atol=rtol * max(np.abs(b).max(), 1e-3), err_msg=k)


@pytest.mark.parametrize("num_iter,soft_mask", [(T, True), (1, False)])
def test_training_forward_matches(weights, num_iter, soft_mask):
    """Soft masks over 2 iterations, hard masks over 1: a hard mask fed back
    flips where a probability sits at 0.5 to within f32 noise, and in
    training a flipped pixel moves the CRE's batch statistics and so every
    later logit."""
    s_img, s_lab, q_img, q_lab = smooth_batch(1)
    model = _jax_model(num_iter, soft_mask)

    def episode(si, sl, qi, ql):
        fore = sl[None, None]
        return model.apply(weights, si[None, None, ..., None], fore, 1.0 - fore,
                           qi[..., None], ql, train=True, mutable=["batch_stats"])

    out, mutated = jax.vmap(episode)(*(jnp.asarray(a[:, 0] if a.ndim == 5 else a)
                                       for a in (s_img, s_lab, q_img, q_lab)))
    new_stats = jax.tree_util.tree_map(lambda a: np.asarray(a).mean(0),
                                       mutated["batch_stats"])

    port = _port_model(weights, num_iter, soft_mask)
    fore = _t(s_lab)[:, None]
    res = port(_t(s_img)[:, None, ..., None], fore, 1.0 - fore,
               _t(q_img)[..., None], _t(q_lab))
    ref_r = np.moveaxis(np.asarray(out["refinement"]), 1, 0)   # (T, E, k, H, W, 2)
    assert res["refinement"].shape == ref_r.shape == (num_iter, E, K, H, H, 2)
    np.testing.assert_allclose(res["refinement"].detach().numpy(), ref_r, atol=5e-3)
    np.testing.assert_allclose(res["align_loss"].detach().numpy(),
                               np.asarray(out["align_loss"]), atol=1e-4)
    _stats_close(port, new_stats, weights["params"], 1e-4)


def _config(**kw):
    cfg = dict(n_way=1, n_shot=1, k=K, crop_size=[H, H], n_iter_refinement=T,
               mask_refinement_correlation_radius=R, use_registration_loss=False,
               reg_affine_iters=8, reg_fit_scale=1, reg_sampler="gather",
               loss="dice_ce", align_loss_scaler=1.0, weight_decay=1e-4,
               scheduler_step=0, compute_dtype=None)
    cfg.update(kw)
    return cfg


def run_jax(variables, cfg, batches, steps_per_epoch=1, x64=False):
    """The JAX package's train steps in f32 or (``x64``) f64 → (losses, the
    state as numpy)."""
    fdt = np.float64 if x64 else np.float32
    r = cfg["mask_refinement_correlation_radius"]
    cast = lambda tree: jax.tree_util.tree_map(lambda a: np.asarray(a, fdt), tree)
    with jax.enable_x64(x64):
        v = cast(variables)
        model = _jax_model(radius=r)
        opt = jax_make_optimizer(cfg, steps_per_epoch=steps_per_epoch)
        state = {"step": np.int32(0), "params": v["params"],
                 "batch_stats": v["batch_stats"], "opt_state": opt.init(v["params"])}
        step = jax.jit(jax_make_train_step(model, cfg, opt))
        jl = []
        for b in batches:
            state, m = step(state, tuple(jnp.asarray(a.astype(fdt)) for a in b))
            jl.append(float(m["loss"]))
        return jl, jax.tree_util.tree_map(np.asarray, state)


def run_port(variables, cfg, batches, steps_per_epoch=1, x64=False):
    """The port's train steps on the same weights → (losses, the model)."""
    fdt = np.float64 if x64 else np.float32
    r = cfg["mask_refinement_correlation_radius"]
    port = _port_model(variables, radius=r).to(torch.float64 if x64 else torch.float32)
    port_step = make_train_step(port, cfg, make_optimizer(port.parameters(), cfg,
                                                          steps_per_epoch))
    pstate = {"step": 0}
    pl = [float(port_step(pstate, tuple(_t(a.astype(fdt)) for a in b))["loss"])
          for b in batches]
    assert pstate["step"] == len(batches)
    return pl, port


def run_both(variables, cfg, batches, steps_per_epoch=1, x64=False):
    """The same train steps in both packages, in f32 or (``x64``) f64.
    Returns (JAX losses, JAX state as numpy, port losses, port model)."""
    jl, state = run_jax(variables, cfg, batches, steps_per_epoch, x64)
    pl, port = run_port(variables, cfg, batches, steps_per_epoch, x64)
    return jl, state, pl, port


def param_change_close(port, jax_params, variables, rel):
    """Each parameter tensor's change from the shared start: the norm of the
    difference within ``rel`` of the norm of the JAX package's change. Every
    conv feeds a batch norm, which cancels its bias: a conv bias gets no
    gradient in exact arithmetic and moves by round-off and its 1e-4 decay
    only, held to 1e-4 absolute."""
    start = state_dict_from_jax(variables)
    ref = state_dict_from_jax({"params": jax_params,
                               "batch_stats": variables["batch_stats"]})
    own = port.state_dict()
    conv_bias = {f"{n}.bias" for n, m in port.named_modules()
                 if isinstance(m, torch.nn.Conv2d)}
    names = [n for n, _ in port.named_parameters()]
    assert len(names) == 2 * (19 + 19) and len(conv_bias) == 19
    for n in names:
        d_ref = (ref[n] - start[n]).numpy()
        d_own = (own[n] - start[n]).numpy()
        if n in conv_bias:
            np.testing.assert_allclose(d_own, d_ref, atol=1e-4, err_msg=n)
        else:
            err = np.linalg.norm(d_own - d_ref) / np.linalg.norm(d_ref)
            assert err <= rel, (n, err)


@pytest.mark.parametrize("radius", [1, R])
def test_sgd_step_matches(weights, radius):
    """One SGD step at lr 1: the parameter change is the gradient (plus the
    decay). Loss to 1e-4; running statistics to 2e-3 of their scale (the
    deepest level's batch statistics come from 8 values per channel and
    episode). Each tensor's change is held to 10% (norm of the difference
    over the norm of the change): at these tiny batches the JAX package's
    own f32 gradient is several percent off its f64 value in the encoder
    (measured up to ~6% of the largest entry; the port's ~0.4%);
    ``test_torch_train_steps.py::test_gradients_match_in_f64`` holds the
    gradients to 1e-5."""
    if radius != R:
        weights = with_radius(weights, radius)
    cfg = _config(optimizer="sgd", init_lr=1.0, momentum=0.9,
                  mask_refinement_correlation_radius=radius)
    jl, jstate, pl, port = run_both(weights, cfg, [smooth_batch(2)])
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    param_change_close(port, jstate["params"], weights, 0.1)
    _stats_close(port, jstate["batch_stats"], jstate["params"], 2e-3)


@pytest.mark.parametrize("name", ["Adam", "sgd"])
def test_optimizer_matches_optax(name):
    """make_optimizer vs the JAX package's: the same gradients through three
    updates across one decay (scheduler_step 1 epoch of 2 updates) give the
    same parameters (1e-5 relative: f32 rounding in another order): decoupled AdamW decay, bias correction,
    staircase schedule over updates, decayed-weight momentum SGD."""
    import optax

    cfg = {"optimizer": name, "init_lr": 1e-2, "weight_decay": 1e-1,
           "scheduler_step": 1, "momentum": 0.9}
    rng = np.random.RandomState(0)
    p0 = rng.randn(4, 5).astype(np.float32)
    grads = [rng.randn(4, 5).astype(np.float32) for _ in range(3)]
    opt = jax_make_optimizer(cfg, steps_per_epoch=2)
    jp, st = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    param = torch.nn.Parameter(_t(p0.copy()))
    topt = make_optimizer([param], cfg, steps_per_epoch=2)
    for n, g in enumerate(grads):
        upd, st = opt.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        param.grad = _t(g)
        for group in topt.param_groups:
            group["lr"] = topt.schedule(n)
        topt.step()
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp), rtol=1e-5,
                                   err_msg=f"update {n}")
