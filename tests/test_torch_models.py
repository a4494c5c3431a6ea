"""rpnet_tpu_torch models vs the JAX package, with the same weights.

The JAX variables (randomized norms) go through the weight bridge
(``state_dict_from_jax``) into the port; both run the eval forward in f32 on
the same numpy inputs (B=2, 64², r=2, 3 refinement iterations). Tolerances:
encoder 2e-4, CRE 5e-4, per-iteration refinement logits 2e-3, thresholded
masks agreeing on more than 99.9% of pixels (a knife-edge pixel may flip and
feed the flip back into later iterations).

Also home of the helpers the other port tests share.
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpnet_tpu.models.rpnet import RPNet as JaxRPNet
from rpnet_tpu_torch.models.rpnet import RPNet
from rpnet_tpu_torch.train.convert import state_dict_from_jax

torch.set_num_threads(2)   # small shapes; the suite runs several workers on one machine


@pytest.fixture(scope="module")
def tensorboard_without_tensorflow():
    """TensorBoard without TensorFlow for a module's CLI runs. The JAX CLIs
    (and the port's train CLI) open a ``SummaryWriter``, whose first write
    imports the installed TensorFlow (~14 s alone, more under the suite's
    workers) unless ``tensorboard.compat.notf`` is importable; with it they
    write the same event files through TensorBoard's own stub. The choice
    is made once per process."""
    key = "tensorboard.compat.notf"
    added = key not in sys.modules
    if added:
        sys.modules[key] = types.ModuleType(key)
    yield
    if added:
        sys.modules.pop(key, None)


def randomize_norms(variables, seed: int):
    """Give every BatchNorm non-default scale/bias/mean/var, so that a bridge
    that swapped or dropped one of them cannot pass unnoticed."""
    rng = np.random.RandomState(seed)

    def walk(params, stats):
        out_p, out_s = {}, {}
        for k, v in params.items():
            if k == "bn":
                n = v["scale"].shape[0]
                out_p[k] = {"scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
                            "bias": rng.normal(0, 0.1, n).astype(np.float32)}
                out_s[k] = {"mean": rng.normal(0, 0.1, n).astype(np.float32),
                            "var": rng.uniform(0.5, 1.5, n).astype(np.float32)}
            elif isinstance(v, dict):
                out_p[k], sub = walk(v, stats.get(k, {}))
                if sub:
                    out_s[k] = sub
            else:
                out_p[k] = np.asarray(v)
        return out_p, out_s

    params, stats = walk(variables["params"], variables["batch_stats"])
    return {"params": params, "batch_stats": stats}


def jax_rpnet(radius: int = 2, num_iter: int = 3, size: int = 32, seed: int = 0):
    """A JAX RPNet (U-Net d4, XLA correlation) and numpy variables with
    randomized norms."""
    model = JaxRPNet(backbone="UNet", num_iter=num_iter, radius=radius,
                     align=False, use_pallas=False)
    H = W = size
    dummy = (jnp.zeros((1, 1, 1, H, W, 1)), jnp.zeros((1, 1, 1, H, W)),
             jnp.ones((1, 1, 1, H, W)), jnp.zeros((1, H, W, 1)),
             jnp.zeros((1, H, W)))
    # jitted: the same draws as an eager init, in a fraction of the CPU time
    init = jax.jit(lambda key, *a: model.init(key, *a, train=False))
    variables = init(jax.random.PRNGKey(seed), *dummy)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    return model, randomize_norms(variables, seed)


def episode_inputs(B: int, H: int, seed: int = 0):
    """Support/query images in [-1, 1] with an elliptic 'organ', binary masks."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:H, :H] / H

    def organ(cy, cx):
        return (((yy - cy) / 0.25) ** 2 + ((xx - cx) / 0.3) ** 2 <= 1).astype(np.float32)

    s_lab = np.stack([organ(0.5 + 0.03 * b, 0.45) for b in range(B)])
    q_lab = np.stack([organ(0.47, 0.5 - 0.02 * b) for b in range(B)])
    s_img = np.clip(0.6 * s_lab - 0.3 + 0.2 * rng.randn(B, H, H), -1, 1).astype(np.float32)
    q_img = np.clip(0.6 * q_lab - 0.3 + 0.2 * rng.randn(B, H, H), -1, 1).astype(np.float32)
    return s_img, s_lab, q_img, q_lab


@pytest.fixture(scope="module")
def pair():
    model, variables = jax_rpnet(radius=2, num_iter=3, size=64, seed=1)
    port = RPNet(radius=2, num_iter=3)
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model, variables, port.eval()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_encoder_matches(pair):
    model, variables, port = pair
    x = np.random.RandomState(2).uniform(-1, 1, (2, 64, 64, 1)).astype(np.float32)
    ref = np.asarray(model.apply(variables, jnp.asarray(x),
                                 method=lambda m, a: m.encoder(a, None, False)["d4"]))
    with torch.no_grad():
        out = port.encoder(_t(x)).numpy()
    assert out.shape == ref.shape == (2, 16, 16, 256)
    np.testing.assert_allclose(out, ref, atol=2e-4)


def test_cre_matches(pair):
    model, variables, port = pair
    rng = np.random.RandomState(3)
    fts = np.abs(rng.randn(2, 16, 16, 256)).astype(np.float32)
    m = (rng.rand(2, 16, 16, 1) > 0.5).astype(np.float32)
    fm1, fm2 = fts * m, fts * (1 - m)
    ref = np.asarray(model.apply(variables, jnp.asarray(fm1), jnp.asarray(fm2),
                                 method=lambda mdl, a, b: mdl.cre(a, b, False)))
    with torch.no_grad():
        out = port.cre(_t(fm1), _t(fm2)).numpy()
    assert out.shape == ref.shape == (2, 16, 16, 64)
    np.testing.assert_allclose(out, ref, atol=5e-4)


def test_refinement_matches(pair):
    model, variables, port = pair
    s_img, s_lab, q_img, q_lab = episode_inputs(2, 64)
    args = (s_img[None, None, ..., None], s_lab[None, None], 1.0 - s_lab[None, None],
            q_img[..., None], q_lab)
    ref = model.apply(variables, *[jnp.asarray(a) for a in args], train=False)
    with torch.no_grad():
        out = port(*[_t(a) for a in args])
    ref_r = np.asarray(ref["refinement"])
    out_r = out["refinement"].numpy()
    assert out_r.shape == ref_r.shape == (3, 2, 64, 64, 2)
    np.testing.assert_array_equal(out["output"].numpy(), out_r[-1])
    for it in range(3):
        np.testing.assert_allclose(out_r[it], ref_r[it], atol=2e-3, err_msg=f"iter {it}")
        agree = np.mean((out_r[it][..., 1] > out_r[it][..., 0])
                        == (ref_r[it][..., 1] > ref_r[it][..., 0]))
        assert agree > 0.999, (it, agree)
