"""rpnet_tpu_torch's training breadth vs the JAX trainer, same weights.

One train step of ``rpnet_tpu.train.trainer.make_train_step`` against the
port's (``rpnet_tpu_torch.train.trainer``) on the same seeded numpy batch
(E=2 episodes of k=2 slices at 32², ``smooth_batch``), weights drawn by
``jax.eval_shape`` shapes from numpy (every norm off its defaults; the
VGG's kernels at He scale) and carried by ``state_dict_from_jax``; 1
soft-mask refinement iteration, r=1, no registration prior, SGD at lr 1
(the parameter change is the gradient plus the decay), f32, for the options
training now takes:

  * ``backbone`` vgg (scale 8) and resnet;
  * ``mask_feature_map: x2``; ``use_relation_enc: concat``;
  * ``unet_normalize_type`` InstanceNorm2d and GroupNorm;
  * ``n_way: 2`` (the support tiled over the ways, 3 output channels);
  * ``compute_dtype: bfloat16``.

Tolerances are ``test_torch_train.test_sgd_step_matches``'s: loss 1e-4
relative, each tensor's change 10% (norm of the difference over the norm of
the JAX change: at these tiny batches the JAX package's own f32 gradient is
several percent off its f64 value; the f64 gradient parity of the step is
``test_torch_train_steps.test_gradients_match_in_f64``'s, and the JAX
trainer cannot run in f64 without the registration prior), running
statistics 2e-3 of their scale; conv biases that a batch or instance norm
cancels, 1e-4 absolute.

``n_way: 2`` is held without the align loss: the tiled ways tie, the second
never wins a query pixel, and the JAX align loss then differentiates
``jnp.linalg.norm`` of a zero prototype, whose gradient is NaN, so the JAX
step's parameters are all NaN after one step (the port's norm has gradient
0 there; its step with the align loss stays finite, which is asserted).

This module holds the helpers and the vgg and resnet steps; the other
cases are ``test_step_matches_jax`` in ``test_torch_train_unet_modes.py``
(mask x2, concat), ``test_torch_norms.py`` (InstanceNorm2d, GroupNorm, with
their eval forward) and ``test_torch_train_nway_bf16.py`` (n_way 2,
bfloat16), files of their own so that the suite's workers split the JAX
compiles between them. Also here: the VGG16 warm start's mapping against the JAX
``convert_torchvision_vgg16`` (exact). The train CLI's ``pretrained_path``
and TensorBoard scalar are held in ``test_torch_train_cli.py``, whose JAX
CLI run has already paid for importing TensorBoard in that worker.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpnet_tpu.models.rpnet import RPNet as JaxRPNet
from rpnet_tpu.train.convert import convert_torchvision_vgg16 as jax_convert_vgg16
from rpnet_tpu.train.trainer import make_optimizer as jax_make_optimizer
from rpnet_tpu.train.trainer import make_train_step as jax_make_train_step
from rpnet_tpu_torch.models.rpnet import RPNet
from rpnet_tpu_torch.train.convert import (convert_torchvision_vgg16,
                                           state_dict_from_jax)
from rpnet_tpu_torch.train.trainer import make_optimizer, make_train_step

from test_torch_backbones import he_kernels, random_variables
from test_torch_train import smooth_batch

torch.set_num_threads(2)   # small shapes; the suite runs several workers on one machine

E, K, H, R, T = 2, 2, 32, 1, 1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# model options (the JAX RPNet's and the port's), config options of the step
CASES = {"vgg": (dict(backbone="vgg", scale=8), {}),
         "resnet": (dict(backbone="resnet", scale=4), {}),
         "mask_x2": (dict(backbone="UNet", mask_feature_map="x2", scale=4), {}),
         "concat": (dict(backbone="UNet", use_relation_enc="concat", scale=4), {}),
         "instance_norm": (dict(backbone="UNet", norm="InstanceNorm2d", scale=4), {}),
         "group_norm": (dict(backbone="UNet", norm="GroupNorm", scale=4), {}),
         "n_way2": (dict(backbone="UNet", scale=4), dict(n_way=2)),
         "bf16": (dict(backbone="UNet", scale=4), dict(compute_dtype="bfloat16"))}


def make_pair(kw, seed: int = 6, align: bool = True):
    """The JAX RPNet (training, with the align loss unless ``align`` is
    off), numpy variables for it, and the port's RPNet carrying them, in
    training mode."""
    jmod = JaxRPNet(num_iter=T, radius=R, align=align, soft_mask=True, **kw)
    dummy = (jnp.zeros((1, 1, 1, H, H, 1)), jnp.zeros((1, 1, 1, H, H)),
             jnp.ones((1, 1, 1, H, H)), jnp.zeros((1, H, H, 1)), jnp.zeros((1, H, H)))
    variables = random_variables(jmod, *dummy, train=False, seed=seed)
    if kw["backbone"] == "vgg":   # no batch norm to renormalize: He scale
        variables["params"]["encoder"] = he_kernels(variables["params"]["encoder"], seed=8)
    port = RPNet(num_iter=T, radius=R, align=align, soft_mask=True, **kw)
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmod, variables, port.train()


def step_config(**kw):
    cfg = dict(n_way=1, n_shot=1, k=K, crop_size=[H, H], n_iter_refinement=T,
               mask_refinement_correlation_radius=R, use_registration_loss=False,
               loss="dice_ce", align_loss_scaler=1.0, optimizer="sgd", init_lr=1.0,
               momentum=0.9, weight_decay=1e-4, scheduler_step=0, compute_dtype=None)
    cfg.update(kw)
    return cfg


def jax_step(jmod, variables, cfg, batch):
    """One JAX train step → (loss, params, batch_stats) as numpy."""
    opt = jax_make_optimizer(cfg)
    state = {"step": np.int32(0), "params": variables["params"],
             "batch_stats": variables["batch_stats"], "opt_state": opt.init(variables["params"])}
    step = jax.jit(jax_make_train_step(jmod, cfg, opt))
    state, m = step(state, tuple(jnp.asarray(a) for a in batch))
    return (float(m["loss"]), jax.tree_util.tree_map(np.asarray, state["params"]),
            jax.tree_util.tree_map(np.asarray, state["batch_stats"]))


def port_step(port, cfg, batch):
    """One port train step on ``port`` (updated in place) → the loss."""
    step = make_train_step(port, cfg, make_optimizer(port.parameters(), cfg))
    return float(step({"step": 0}, tuple(_t(a) for a in batch))["loss"])


def changes_close(port, start, jparams, jstats, rel, stats_rel, cancelled):
    """Each parameter's change from ``start`` against the JAX step's, within
    ``rel`` of the JAX change's norm (``cancelled`` biases 1e-4 absolute),
    and the running statistics within ``stats_rel`` of their scale."""
    ref = state_dict_from_jax({"params": jparams, "batch_stats": jstats})
    own = port.state_dict()
    names = [n for n, _ in port.named_parameters()]
    assert names and set(names) <= set(ref)
    for n in names:
        d_ref = (ref[n] - start[n]).numpy()
        d_own = (own[n] - start[n]).numpy()
        if n in cancelled:
            np.testing.assert_allclose(d_own, d_ref, atol=1e-4, err_msg=n)
        else:
            err = np.linalg.norm(d_own - d_ref) / np.linalg.norm(d_ref)
            assert err <= rel, (n, err)
    for k in ref:
        if k.endswith(("running_mean", "running_var")):
            a, b = own[k].numpy(), ref[k].numpy()
            np.testing.assert_allclose(a, b, atol=stats_rel * max(np.abs(b).max(), 1e-3),
                                       err_msg=k)


def cancelled_biases(port):
    """Biases of the convolutions that feed a batch or instance norm, which
    subtracts every per-channel constant: no gradient in exact arithmetic."""
    from rpnet_tpu_torch.models.blocks import BatchNorm2d, InstanceNorm2d

    out = set()
    for name, mod in port.named_modules():
        kids = list(mod.named_children())
        for (n1, m1), (_, m2) in zip(kids, kids[1:]):
            if isinstance(m1, torch.nn.Conv2d) and isinstance(m2, (BatchNorm2d, InstanceNorm2d)):
                out.add(f"{name}.{n1}.bias")
    return out


def check_step(case):
    """One step of ``case`` in both packages, held to the module's
    tolerances."""
    kw, extra = CASES[case]
    align = case != "n_way2"
    jmod, variables, port = make_pair(kw, align=align)
    cfg = step_config(**extra)
    batch = smooth_batch(2, k=K, size=H)
    start = {k: v.clone() for k, v in port.state_dict().items()}
    jl, jparams, jstats = jax_step(jmod, variables, cfg, batch)
    pl = port_step(port, cfg, batch)
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    changes_close(port, start, jparams, jstats, 0.1, 2e-3, cancelled_biases(port))
    if not align:   # the port's step with the align loss stays finite
        port = make_pair(kw)[2]
        port_step(port, cfg, batch)
        assert all(torch.isfinite(p).all() for p in port.parameters())


@pytest.mark.parametrize("case", ["vgg", "resnet"])
def test_step_matches_jax(case):
    check_step(case)


def torchvision_vgg16(seed: int):
    """A torchvision-named VGG16 state dict (``features`` convs at their
    indices, a ``classifier`` tensor pair) drawn from ``seed``."""
    rng = np.random.RandomState(seed)
    sd, cin = {}, 3
    chans = [c for n, c in ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512)) for _ in range(n)]
    for idx, cout in zip((0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28), chans):
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            rng.randn(cout, cin, 3, 3).astype(np.float32) * 0.05)
        sd[f"features.{idx}.bias"] = torch.from_numpy(rng.randn(cout).astype(np.float32))
        cin = cout
    sd["classifier.0.weight"] = torch.zeros(4, 4)
    sd["classifier.0.bias"] = torch.zeros(4)
    return sd


def test_torchvision_vgg16_mapping_matches_jax():
    """The port's ``convert_torchvision_vgg16`` against the JAX one on the
    same seeded state dict: the same 13 (weight, bias) pairs, exactly, in
    the encoder's positional order (``features.10`` after ``features.7``)."""
    sd = torchvision_vgg16(1)
    port = convert_torchvision_vgg16(sd)
    ref = state_dict_from_jax({"params": jax_convert_vgg16(sd)["params"],
                               "batch_stats": {}})
    assert set(port) == set(ref) and len(port) == 26
    for k, v in ref.items():
        assert torch.equal(port[k], v), k
    assert torch.equal(port["encoder.features.4.0.weight"], sd["features.10.weight"])
