"""bf16 eval, the default eval dtype, held against the JAX package.

Both RPNet eval forwards run in bf16 on the same numpy inputs (B=2 at 64²,
r=5, 3 refinement iterations), with the weights carried by the bridge
(``state_dict_from_jax``) and cast as each package's eval runner casts them:
the JAX variables' f32 leaves and the five inputs to bf16
(``rpnet_tpu/episode/pipeline.py:102-104``, ``:185-191``), the port's model
and inputs with ``.to(torch.bfloat16)`` (``rpnet_tpu_torch/episode/pipeline.py``).

Where the two packages compute the same bf16 operations in the same order
the results are compared bit for bit: the prototypes from one set of CRE
features (mask resized in bf16, sums in f32, one cast) and the logit
upsample (two resize products, each rounded), a convolution with its bias
(flax adds the bias after the convolution's rounding) and batch norm (flax
rounds after each of ``x - mean``, ``· mul``, ``+ bias``). The port's bf16
eval follows those roundings, and the CRE's 1×1 ``q`` conv and the cosine
norms as the JAX package computes them. The whole forward is compared by
mask agreement and Dice, not bit for bit: the convolutions' and the
reductions' f32 sums run in other orders, one ulp moves a logit on the
random-weight network's near-threshold pixels, and the hard 0.5 threshold
feeds each flip into the next iteration (measured: agreement 0.9929,
0.9888, 0.9880 over the three iterations; last-iteration Dice 0.8652 vs
0.8737 against the label).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpnet_tpu.ops.sampling import interpolate_bilinear as jax_interpolate
from rpnet_tpu_torch.models.rpnet import RPNet, masked_average_pool
from rpnet_tpu_torch.ops.sampling import interpolate_bilinear
from rpnet_tpu_torch.train.convert import state_dict_from_jax
from test_torch_models import episode_inputs, jax_rpnet

B, H, R, ITERS = 2, 64, 5, 3
# per-iteration mask agreement and last-iteration Dice Δ: see module doc
MIN_AGREE = 0.98
MAX_DICE_DELTA = 0.01


def _bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _t(a):
    """A JAX bf16 array → the same values as a torch bf16 tensor."""
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).to(torch.bfloat16)


@pytest.fixture(scope="module")
def nets():
    model, variables = jax_rpnet(radius=R, num_iter=ITERS, size=H, seed=1)
    vb = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16) if x.dtype == np.float32 else x, variables)
    port = RPNet(radius=R, num_iter=ITERS)
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model, vb, port.eval().to(torch.bfloat16)


@pytest.fixture(scope="module")
def forwards(nets):
    model, vb, port = nets
    s_img, s_lab, q_img, q_lab = episode_inputs(B, H)
    prior = np.roll(q_lab, 3, axis=-1)   # a registration prior that is not the label
    fore = s_lab[None, None]
    args = [_bf16(a) for a in (s_img[None, None, ..., None], fore, 1.0 - fore,
                               q_img[..., None], prior)]
    apply = jax.jit(lambda v, *a: model.apply(v, *a, train=False))
    ref = np.asarray(apply(vb, *args)["refinement"].astype(jnp.float32))
    with torch.no_grad():
        out = port(*[_t(a) for a in args])
    assert out["refinement"].dtype == torch.bfloat16
    return out["refinement"].float().numpy(), ref, q_lab


def test_bf16_prototypes_match(nets):
    """The same bf16 CRE features and full-resolution masks through the JAX
    ``RPNet._prototypes`` and the port's pooling (``masked_average_pool``,
    mean over shots, cast to the network dtype): equal bit for bit."""
    model, vb, _ = nets
    rng = np.random.RandomState(4)
    fts = _bf16(np.abs(rng.randn(1, 1, B, H // 4, H // 4, 64)))
    _, s_lab, _, _ = episode_inputs(B, H, seed=4)
    fore = _bf16(s_lab[None, None])
    back = _bf16(1.0 - s_lab[None, None])
    fg_ref, bg_ref = model.apply(vb, fts, fore, back,
                                 method=lambda m, *a: m._prototypes(*a))
    fg = masked_average_pool(_t(fts)[0, 0], _t(fore)[0, 0]).to(torch.bfloat16)
    bg = masked_average_pool(_t(fts)[0, 0], _t(back)[0, 0]).to(torch.bfloat16)
    np.testing.assert_array_equal(fg.float().numpy(),
                                  np.asarray(fg_ref[0].astype(jnp.float32)))
    np.testing.assert_array_equal(bg.float().numpy(),
                                  np.asarray(bg_ref.astype(jnp.float32)))


def test_bf16_logit_upsample_matches():
    """Feature-resolution logits 16² → 64² in bf16: the port's upsample
    rounds after each of its two resize products, as the JAX one does, and
    equals it bit for bit."""
    x = _bf16(5 * np.random.RandomState(5).randn(B, H // 4, H // 4, 2))
    ref = np.asarray(jax_interpolate(x, (H, H)).astype(jnp.float32))
    out = interpolate_bilinear(_t(x), (H, H))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), ref)


@pytest.mark.parametrize("it", range(ITERS))
def test_bf16_eval_masks_agree(forwards, it):
    """Each iteration's > 0.5 masks agree on more than MIN_AGREE of pixels."""
    out, ref, _ = forwards
    assert out.shape == ref.shape == (ITERS, B, H, H, 2)
    agree = np.mean((out[it][..., 1] > out[it][..., 0]) == (ref[it][..., 1] > ref[it][..., 0]))
    assert agree > MIN_AGREE, agree


def test_bf16_eval_dice(forwards):
    """The last iteration's Dice against the label, within MAX_DICE_DELTA."""
    out, ref, q_lab = forwards

    def dice(logits):
        p = logits[..., 1] > logits[..., 0]
        return 2 * np.sum(p * q_lab) / (np.sum(p) + np.sum(q_lab))

    d_port, d_ref = dice(out[-1]), dice(ref[-1])
    assert d_ref > 0.5   # a mask that overlaps the organ, not an empty one
    assert abs(d_port - d_ref) < MAX_DICE_DELTA, (d_port, d_ref)


def test_bf16_batch_norm_rounding_order():
    """flax's eval batch norm in bf16 equals ``((x - mean) * (rsqrt(var +
    eps) * scale)) + bias`` rounded to bf16 after each operation, and the
    port's ``BatchNorm2d`` in bf16 eval equals flax's bit for bit."""
    import flax.linen as fnn

    from rpnet_tpu_torch.models.blocks import BatchNorm2d

    rng = np.random.RandomState(6)
    C = 64
    x = _bf16(rng.randn(2, 16, 16, C))
    stats = [rng.uniform(0.5, 1.5, C), rng.normal(0, 0.1, C),
             rng.normal(0, 0.1, C), rng.uniform(0.5, 1.5, C)]
    scale, bias, mean, var = (_bf16(a) for a in stats)
    ref = fnn.BatchNorm(use_running_average=True, epsilon=1e-5).apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean, "var": var}}, x)
    ref = np.asarray(ref.astype(jnp.float32))
    tx, ts, tb, tm, tv = (_t(a) for a in (x, scale, bias, mean, var))
    per_op = (tx - tm) * (torch.rsqrt(tv + 1e-5) * ts) + tb
    np.testing.assert_array_equal(per_op.float().numpy(), ref)
    bn = BatchNorm2d(C).eval().to(torch.bfloat16)
    with torch.no_grad():
        bn.weight.copy_(ts), bn.bias.copy_(tb)
        bn.running_mean.copy_(tm), bn.running_var.copy_(tv)
        port = bn(tx)
    assert port.dtype == torch.bfloat16
    np.testing.assert_array_equal(port.float().numpy(), ref)


def test_bf16_conv_bias_rounding():
    """A 3×3 conv with bias in bf16: the port's ``Conv2d`` adds the bias
    after the convolution's rounding, as flax's ``nn.Conv``, and equals the
    JAX package's ``TorchConv`` bit for bit on these inputs (torch's fused
    bias rounds once: 27% of outputs one ulp apart)."""
    from rpnet_tpu.models.blocks import TorchConv
    from rpnet_tpu_torch.models.blocks import Conv2d

    rng = np.random.RandomState(7)
    x = _bf16(rng.randn(2, 16, 16, 64))
    jconv = TorchConv(64, (3, 3))
    v = jconv.init(jax.random.PRNGKey(0), x.astype(jnp.float32))
    ref = np.asarray(jconv.apply(jax.tree_util.tree_map(_bf16, v), x).astype(jnp.float32))
    conv = Conv2d(64, 64, 3, padding=1)
    with torch.no_grad():
        kernel = np.asarray(v["params"]["conv"]["kernel"]).transpose(3, 2, 0, 1)
        conv.weight.copy_(torch.from_numpy(kernel.copy()))
        conv.bias.copy_(torch.from_numpy(np.asarray(v["params"]["conv"]["bias"])))
        out = conv.to(torch.bfloat16)(_t(x))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), ref)
