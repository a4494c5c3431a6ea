"""rpnet_tpu_torch's eval breadth in models vs the JAX package, same weights.

Random numpy weights shaped by the JAX modules (``jax.eval_shape`` of their
init, every BatchNorm randomized) go through the weight bridge into the
port; both packages run on the same numpy inputs in f32 on the CPU (B=2 at
64²). Tolerances: encoders 2e-4 (VGG, ResNet, the U-Net with the mask
injected at x, x2, x3 and x5), the CRE and ``SimpleConcat`` at C = 512 5e-4,
per-iteration refinement logits 2e-3 with masks agreeing on more than 99.9%
of pixels (``vgg`` + ``relation``, ``UNet`` + ``concat``, and the U-Net with
the mask at x2, whose merged eval pass encodes the query with support
(0, 0)'s mask). The U-Net encoders run at 32². The JAX ``convert_state_dict``
inverts the bridge exactly for every backbone; it leaves the ``concat``
mode's ``sim_cat.*`` unmapped (upstream never defined the module).

The VGG and U-Net encoders' kernels are drawn at He scale (VGG's own
kaiming-normal init): at torch's default scale each conv shrinks the image's
share of the activations (VGG has no batch norm, and an eval-mode batch norm
with running statistics does not renormalize) until the biases set the
output. Each test also shows
that the output depends on what it checks: a zeroed or channel-reversed
image, a zeroed mask, a query encoded without its mask, and a VGG image put
in one channel instead of three each move the outputs by more than
``MOVES`` × their tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpnet_tpu.models.cre import ContextCorrelationEncoder as JaxCRE
from rpnet_tpu.models.cre import SimpleConcat as JaxSimpleConcat
from rpnet_tpu.models.resnet import ResNet18Encoder as JaxResNet
from rpnet_tpu.models.rpnet import RPNet as JaxRPNet
from rpnet_tpu.models.unet import UNet as JaxUNet
from rpnet_tpu.models.vgg import VGGEncoder as JaxVGG
from rpnet_tpu.train.convert import convert_state_dict
from rpnet_tpu_torch.config import Config
from rpnet_tpu_torch.models.cre import ContextCorrelationEncoder, SimpleConcat
from rpnet_tpu_torch.models.factory import build_rpnet
from rpnet_tpu_torch.models.resnet import ResNet18Encoder
from rpnet_tpu_torch.models.rpnet import RPNet
from rpnet_tpu_torch.models.unet import UNet
from rpnet_tpu_torch.models.vgg import VGGEncoder
from rpnet_tpu_torch.train.convert import load_into, state_dict_from_jax
from rpnet_tpu_torch.train.trainer import make_optimizer, make_train_step

from test_torch_models import episode_inputs

torch.set_num_threads(2)   # small shapes; the suite runs several workers on one machine

H = 64
MOVES = 50   # a mutation must move the outputs by this many tolerances


def random_variables(module, *args, seed: int = 0, **kw):
    """numpy variables of ``module``'s shapes: conv kernels U(±1/√fan_in)
    (torch's default init, as the other parity tests' weights), biases
    N(0, 0.05), every BatchNorm's scale, bias, mean and var off their
    defaults. Shapes come from ``jax.eval_shape`` (traced, not compiled)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kw))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            bound = 1.0 / np.sqrt(fan_in)
            return rng.uniform(-bound, bound, shape).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (rng.randn(*shape) * (0.1 if name == "mean" else 0.05)).astype(np.float32)

    out = jax.tree_util.tree_map_with_path(fill, shapes)
    return {"params": out["params"], "batch_stats": out.get("batch_stats", {})}


def he_kernels(params, seed: int):
    """``params`` with every conv kernel redrawn N(0, 2/fan_in), the ReLU
    gain that keeps a net without batch norm (VGG) from shrinking its input."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        if path[-1].key != "kernel":
            return leaf
        std = np.sqrt(2.0 / np.prod(leaf.shape[:-1]))
        return (rng.randn(*leaf.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, params)


def max_moved(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


# (JAX module, its options, the port's, its options, input channels, size,
#  He-scale kernels)
ENCODERS = {"vgg": (JaxVGG, {}, VGGEncoder, {}, 3, H, True),
            "resnet": (JaxResNet, {}, ResNet18Encoder, {}, 3, H, False),
            **{f"unet_{m}": (JaxUNet, dict(mask_feature_map=m), UNet,
                             dict(mask_feature_map=m), 1, 32, True)
               for m in ("x", "x2", "x3", "x5")}}


@pytest.mark.parametrize("name", list(ENCODERS))
def test_encoder_matches_and_bridge_round_trips(name):
    jcls, jkw, tcls, tkw, cin, size, he = ENCODERS[name]
    jmod = jcls(**jkw)
    rng = np.random.RandomState(1)
    x = rng.uniform(-1, 1, (2, size, size, cin)).astype(np.float32)
    mask = (rng.rand(2, size, size, 1) > 0.6).astype(np.float32)
    enc = random_variables(jmod, jnp.zeros((1, size, size, cin)),
                           jnp.zeros((1, size, size, 1)), False, seed=2)
    if he:
        enc["params"] = he_kernels(enc["params"], seed=7)
    variables = {"params": {"encoder": enc["params"]},
                 "batch_stats": {"encoder": enc["batch_stats"]} if enc["batch_stats"] else {}}
    sd = state_dict_from_jax(variables)
    port = tcls(**tkw).eval()
    port.load_state_dict({k[len("encoder."):]: v for k, v in sd.items()}, strict=True)

    ref = np.asarray(jax.jit(lambda v, a, m: jmod.apply(v, a, m, False)["d4"])(
        enc, jnp.asarray(x), jnp.asarray(mask)))
    with torch.no_grad():
        out = port(_t(x), _t(mask)).numpy()
    assert out.shape == ref.shape
    assert out.shape[-1] == port.out_channels
    np.testing.assert_allclose(out, ref, atol=2e-4)
    with torch.no_grad():
        assert max_moved(port(_t(np.zeros_like(x)), _t(mask)), out) > MOVES * 2e-4
        if cin == 3:
            assert max_moved(port(_t(x[..., ::-1]), _t(mask)), out) > MOVES * 2e-4
        if port.__class__ is UNet:
            assert max_moved(port(_t(x), _t(np.zeros_like(mask))), out) > MOVES * 2e-4

    back = convert_state_dict(sd)
    for part in ("params", "batch_stats"):
        want = dict(_flat(variables[part]))
        got = dict(_flat(back[part]))
        assert set(got) == set(want), part
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    assert all(k.endswith("num_batches_tracked") for k in back["_unmatched_keys"])


@pytest.mark.parametrize("kind", ["cre", "concat"])
def test_relation_modules_at_512_channels(kind):
    C, h = 512, 8
    rng = np.random.RandomState(3)
    fts = np.abs(rng.randn(2, h, h, C)).astype(np.float32)
    m = (rng.rand(2, h, h, 1) > 0.5).astype(np.float32)
    if kind == "cre":
        jmod, args = JaxCRE(radius=2, use_pallas=False), (fts * m, fts * (1 - m))
        port = ContextCorrelationEncoder(C, 2)
    else:
        jmod, args = JaxSimpleConcat(), (fts, m)
        port = SimpleConcat(C)
    v = random_variables(jmod, *[jnp.zeros_like(jnp.asarray(a)) for a in args], False, seed=4)
    sd = state_dict_from_jax({"params": {kind if kind == "cre" else "sim_cat": v["params"]},
                              "batch_stats": {kind if kind == "cre" else "sim_cat":
                                              v["batch_stats"]}})
    port.load_state_dict({k.split(".", 1)[1]: w for k, w in sd.items()}, strict=True)
    ref = np.asarray(jmod.apply(v, *[jnp.asarray(a) for a in args], False))
    with torch.no_grad():
        out = port.eval()(*[_t(a) for a in args]).numpy()
    assert out.shape == ref.shape == (2, h, h, 64)
    np.testing.assert_allclose(out, ref, atol=5e-4)


MODELS = {"vgg_relation": dict(backbone="vgg", scale=8),
          "unet_concat": dict(backbone="UNet", use_relation_enc="concat", scale=4),
          "unet_x2": dict(backbone="UNet", mask_feature_map="x2", scale=4)}


@pytest.mark.parametrize("name", list(MODELS))
def test_refinement_matches(name):
    kw = MODELS[name]
    jmod = JaxRPNet(num_iter=2, radius=2, align=False, use_pallas=False, **kw)
    s_img, s_lab, q_img, q_lab = episode_inputs(2, H, seed=5)
    args = (s_img[None, None, ..., None], s_lab[None, None], 1.0 - s_lab[None, None],
            q_img[..., None], np.roll(q_lab, 3, axis=-1))
    dummy = (jnp.zeros((1, 1, 1, H, H, 1)), jnp.zeros((1, 1, 1, H, H)),
             jnp.ones((1, 1, 1, H, H)), jnp.zeros((1, H, H, 1)), jnp.zeros((1, H, H)))
    variables = random_variables(jmod, *dummy, train=False, seed=6)
    variables["params"]["encoder"] = he_kernels(variables["params"]["encoder"], seed=8)
    cfg = dict(kw, mask_refinement_correlation_radius=2)
    port = build_rpnet(cfg, num_iter=2)
    assert load_into(port, state_dict_from_jax(variables)) == []
    ref = jax.jit(lambda v, *a: jmod.apply(v, *a, train=False)["refinement"])(
        variables, *[jnp.asarray(a) for a in args])
    with torch.no_grad():
        out = port(*[_t(a) for a in args])["refinement"].numpy()
    ref = np.asarray(ref)
    assert out.shape == ref.shape == (2, 2, H, H, 2)
    for it in range(2):
        np.testing.assert_allclose(out[it], ref[it], atol=2e-3, err_msg=f"iter {it}")
        agree = np.mean((out[it][..., 1] > out[it][..., 0]) == (ref[it][..., 1] > ref[it][..., 0]))
        assert agree > 0.999, (it, agree)

    # each mutation must move the logits by many tolerances
    encode = port._encode
    mutations = {"zeroed query image": lambda imgs, masks: encode(
        torch.cat([imgs[:-2], torch.zeros_like(imgs[-2:])]), masks)}
    if kw["backbone"] == "vgg":
        mutations["image in one channel of three"] = lambda imgs, masks: port.encoder(
            torch.nn.functional.pad(imgs, (0, 2)))
    if kw.get("mask_feature_map"):
        mutations["query encoded without a mask"] = lambda imgs, masks: encode(
            imgs, torch.cat([masks[:-2], torch.zeros_like(masks[-2:])]))
    for what, mutated in mutations.items():
        port._encode = mutated
        with torch.no_grad():
            moved = max_moved(port(*[_t(a) for a in args])["refinement"], out)
        assert moved > MOVES * 2e-3, (what, moved)
    if name == "unet_concat":
        back = convert_state_dict(state_dict_from_jax(variables))["_unmatched_keys"]
        assert sorted(k for k in back if not k.endswith("num_batches_tracked")) == [
            "sim_cat.proj.0.bias", "sim_cat.proj.0.weight", "sim_cat.proj.1.bias",
            "sim_cat.proj.1.running_mean", "sim_cat.proj.1.running_var",
            "sim_cat.proj.1.weight"]


def test_factory_scale_and_checkpoint_shapes():
    assert Config({"backbone": "vgg"})["scale"] == 8
    assert Config({"backbone": "resnet"})["scale"] == 4
    assert Config({"backbone": "vgg", "scale": 4})["scale"] == 4
    assert build_rpnet({"backbone": "vgg"}, num_iter=1).scale == 8
    plain = UNet(mask_feature_map=False).state_dict()
    assert plain["Conv1.conv.0.weight"].shape[1] == 1
    injected = RPNet(mask_feature_map="x")
    assert injected.state_dict()["encoder.Conv1.conv.0.weight"].shape[1] == 2
    with pytest.raises(RuntimeError, match="size mismatch for encoder.Conv1.conv.0.weight"):
        load_into(injected, RPNet().state_dict())


@pytest.mark.parametrize("key,val", [("backbone", "vgg"), ("backbone", "resnet"),
                                     ("mask_feature_map", "x2"),
                                     ("use_relation_enc", "concat")])
def test_training_takes_the_eval_breadth_modes(key, val):
    """Each eval breadth mode trains: the train step builds and takes one
    finite step on a tiny batch that moves the parameters (the step is held
    against the JAX trainer in ``test_torch_train_breadth.py``)."""
    cfg = {key: val, "mask_refinement_correlation_radius": 1, "n_iter_refinement": 1,
           "use_registration_loss": False, "optimizer": "sgd", "init_lr": 1e-2,
           "scheduler_step": 0}
    model = build_rpnet(cfg, num_iter=1)
    before = [p.detach().clone() for p in model.parameters()]
    step = make_train_step(model, cfg, make_optimizer(model.parameters(), cfg))
    rng = np.random.RandomState(0)
    lab = (rng.rand(1, 1, 1, 32, 32) > 0.5).astype(np.float32)
    batch = (rng.randn(1, 1, 1, 32, 32).astype(np.float32), lab,
             rng.randn(1, 1, 32, 32).astype(np.float32), lab[:, 0])
    loss = float(step({"step": 0}, tuple(_t(a) for a in batch))["loss"])
    assert np.isfinite(loss)
    assert any(not torch.equal(a, p) for a, p in zip(before, model.parameters()))
