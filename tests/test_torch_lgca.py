"""rpnet_tpu_torch's LGCANet_V3 (``models/lgca.py``) vs the JAX package's
(``rpnet_tpu/models/lgca.py``), same weights, f32 on the CPU.

Sizes: slices (3, 32, 32, 1), volume (1, 8, 16, 16, 1) (d4 is 1×2×2, pooled
to 4×4 by the last attention level), ``feature_scale`` 8 (U-Net widths
8..128), 2 ROIs. The JAX weights are random (``random_lgca_variables``:
shapes from ``jax.eval_shape`` of the init, He-scaled kernels, randomized
norms; ``jax_variables``, no compile) and reach the port through
``lgca_state_dict_from_jax``. The whole model's forward under each U-Net
and norm: ``test_torch_lgca_forward.py``.

  * the 3D ops, adaptive pools (also 2 → 4) and trilinear ×8: 1e-5;
  * ``FeatureNet`` d1..d4 and ``dsv``: 1e-4 × max|ref|;
  * ``AttentionLayer`` (att 1e-5, fused 1e-4) and ``MultiHeadAttentionLayer``
    in eval, and a case showing that flattening the 2D embedding in NCHW's
    natural order would not hold;
  * the bridge: ``convert_lgca_state_dict(lgca_state_dict_from_jax(v))``
    equals ``v`` leaf for leaf (BatchNorm2d and InstanceNorm2d; the JAX
    converter maps batch norms only, as for RP_Net, so a GroupNorm's scale
    and bias do not round-trip through it), the port loading the bridged
    dict strictly; ``load_into`` skips and returns the upstream's dead keys,
    which the JAX converter reports as unmatched.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpnet_tpu.models import lgca as jl
from rpnet_tpu.train.convert import convert_lgca_state_dict
from rpnet_tpu_torch.models import lgca as tl
from rpnet_tpu_torch.train.convert import lgca_state_dict_from_jax, load_into

torch.set_num_threads(2)   # small shapes; the suite runs several workers on one machine

B, H, D, K, FS = 3, 32, 8, 2, 8.0
CASES = [(False, "BatchNorm2d"), (True, "BatchNorm2d"), (False, "InstanceNorm2d"),
         (True, "InstanceNorm2d"), (False, "GroupNorm")]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def random_lgca_variables(model, volume, slices, seed: int):
    """Random numpy variables of the JAX ``model`` (no init compiled): He
    normal kernels, biases N(0, 0.1), norm scales U(0.5, 1.5), running
    variances U(0.5, 1.5), means N(0, 0.1)."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), volume, slices,
                                               train=False))

    def fill(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = fill(dict(v))
            elif k == "kernel":
                fan_in = int(np.prod(v.shape[:-1]))
                out[k] = (rng.randn(*v.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
            elif k in ("scale", "var"):
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            else:
                out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        return out

    variables = fill(dict(shapes))
    variables.setdefault("batch_stats", {})
    return variables


def inputs(seed: int = 0, b: int = B):
    rng = np.random.RandomState(seed)
    volume = rng.randn(1, D, H // 2, H // 2, 1).astype(np.float32)
    slices = rng.randn(b, H, H, 1).astype(np.float32)
    mask = (rng.rand(b, H, H, K) > 0.7).astype(np.float32)
    vmask = (rng.rand(1, D, H // 2, H // 2, K) > 0.7).astype(np.float32)
    mask[..., 1] = 0                        # an empty class in the slices
    return volume, slices, mask, vmask


def port_model(variables, gates: bool, norm: str) -> tl.LGCANetV3:
    model = tl.LGCANetV3(output_ch=K, norm=norm, feature_scale=FS, attention_gates=gates)
    model.load_state_dict(lgca_state_dict_from_jax(variables), strict=True)
    return model.eval()


_VARIABLES = {}


def jax_variables(gates: bool, norm: str):
    """Random numpy variables of the JAX LGCANetV3 of a case, once per
    process (no compile)."""
    key = (gates, norm)
    if key not in _VARIABLES:
        model = jl.LGCANetV3(output_ch=K, norm=norm, feature_scale=FS, attention_gates=gates)
        volume, slices = inputs()[:2]
        _VARIABLES[key] = random_lgca_variables(model, volume, slices,
                                                seed=3 + CASES.index(key))
    return _VARIABLES[key]


# ---------------------------------------------------------------- 3D ops

def _ncdhw(a):
    return np.transpose(a, (0, 4, 1, 2, 3))


@pytest.mark.parametrize("op", ["instance_norm", "max_pool", "adaptive_2d",
                                "adaptive_2_to_4", "adaptive_3d", "trilinear"])
def test_ops_match_jax(op):
    rng = np.random.RandomState(1)
    if op == "instance_norm":
        x = (rng.randn(2, 4, 6, 6, 5) * 3 + 1).astype(np.float32)
        ref, out = jl.instance_norm_3d(jnp.asarray(x)), tl.instance_norm_3d(_t(x))
    elif op == "max_pool":
        x = rng.randn(1, 5, 6, 7, 3).astype(np.float32)   # odd sizes drop the tail
        ref, out = jl.max_pool3d(jnp.asarray(x)), tl.max_pool3d(_t(x))
    elif op in ("adaptive_2d", "adaptive_2_to_4"):
        x = rng.randn(2, *((13, 17) if op == "adaptive_2d" else (2, 2)), 3).astype(np.float32)
        ref, out = jl.adaptive_max_pool2d(jnp.asarray(x), 4), tl.adaptive_max_pool2d(_t(x), 4)
    elif op == "adaptive_3d":
        x = rng.randn(1, 3, 9, 11, 2).astype(np.float32)   # depth untouched
        ref = jl.adaptive_max_pool2d(jnp.asarray(x), 4)
        out = tl.adaptive_max_pool3d_hw(_t(x), 4)
    else:
        x = rng.randn(1, 2, 3, 4, 5).astype(np.float32)
        ref = jax.image.resize(jnp.asarray(x), (1, 16, 24, 32, 5), method="trilinear")
        out = tl.upsample_trilinear(_t(x), 8)
    ref = np.asarray(ref)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


# ---------------------------------------------------------------- modules

def test_feature_net_matches_jax():
    variables = jax_variables(False, "BatchNorm2d")
    volume = inputs()[0]
    ref = jax.jit(jl.FeatureNet(out_channels=K).apply)(
        {"params": variables["params"]["context_net"]}, volume)
    port = port_model(variables, False, "BatchNorm2d").context_net
    with torch.no_grad():
        out = port(_t(volume))
    shapes = {"d1": (1, 8, 16, 16, 24), "d2": (1, 4, 8, 8, 32), "d3": (1, 2, 4, 4, 64),
              "d4": (1, 1, 2, 2, 64), "dsv": (1, 8, 16, 16, K)}
    for k, shape in shapes.items():
        r = np.asarray(ref[k])
        assert tuple(out[k].shape) == r.shape == shape, k
        np.testing.assert_allclose(out[k].numpy(), r, atol=1e-4 * np.abs(r).max(), err_msg=k)


def _natural_order_att(layer: tl.AttentionLayer, feat_2d, feat_3d):
    """The head's attention with the 2D embedding flattened in NCHW's
    natural (F, E, E) order."""
    B_, D_ = feat_2d.shape[0], feat_3d.shape[1]
    sig2 = layer.global_pooling_2D(feat_2d).permute(0, 3, 1, 2).reshape(B_, -1)
    sig3 = layer.global_pooling_3D(feat_3d)[0].permute(3, 1, 2, 0).reshape(-1, D_)
    return torch.softmax(sig2 @ sig3 / np.sqrt(sig2.shape[-1]), dim=1)


@pytest.mark.parametrize("level", [1, 2])
def test_slice_attention_matches_jax(level):
    """Level 1 (2 heads, 2 features, 16² embedding, 8 depths of d1) and
    level 2 (8² embedding, 4 depths of d2) with the full model's weights:
    each head's attention (B, D) within 1e-5 and its fused map within 1e-4;
    the multi-head layer's fused, normalized map within 1e-4 and attention
    within 1e-5; the natural NCHW flatten gives other attention."""
    variables = jax_variables(False, "BatchNorm2d")
    heads, nf, ne = jl._ATT_SPEC[level - 1]
    c2, c3 = int(64 * 2 ** (level - 1) / FS), jl.P_NUM[level - 1]
    hw, depth = H // 2 ** level, D // 2 ** (level - 1)
    rng = np.random.RandomState(10 + level)
    feat_2d = np.abs(rng.randn(B, hw, hw, c2)).astype(np.float32)
    feat_3d = np.abs(rng.randn(1, depth, hw, hw, c3)).astype(np.float32)
    jv = variables["params"]["unet"][f"self_attention{level}"]
    port = port_model(variables, False, "BatchNorm2d").unet
    mh = getattr(port, f"self_attention{level}")
    with torch.no_grad():
        for i in range(heads):
            ref_f, ref_a = jax.jit(jl.AttentionLayer(nf, ne).apply)(
                {"params": jv[f"att_layer_{i}"]}, feat_2d, feat_3d)
            layer = getattr(mh, f"att_layer_{i}")
            fused, att = layer(_t(feat_2d), _t(feat_3d))
            assert tuple(att.shape) == (B, depth)
            np.testing.assert_allclose(att.numpy(), np.asarray(ref_a), atol=1e-5)
            np.testing.assert_allclose(fused.numpy(), np.asarray(ref_f), atol=1e-4)
            natural = _natural_order_att(layer, _t(feat_2d), _t(feat_3d)).numpy()
            assert np.abs(natural - np.asarray(ref_a)).max() > 1e-2
        stats = variables["batch_stats"]["unet"][f"self_attention{level}"]
        ref_x, ref_att = jax.jit(jl.MultiHeadAttentionLayer(heads, nf, ne).apply)(
            {"params": jv, "batch_stats": stats}, feat_2d, feat_3d)
        x, att = mh(_t(feat_2d), _t(feat_3d))
    assert tuple(att.shape) == (B, depth, heads) and tuple(x.shape) == (B, hw, hw, c3)
    np.testing.assert_allclose(att.numpy(), np.asarray(ref_att), atol=1e-5)
    np.testing.assert_allclose(x.numpy(), np.asarray(ref_x), atol=1e-4)


# ---------------------------------------------------------------- bridge

def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("gates,norm", CASES[:4])
def test_bridge_round_trip_is_exact(gates, norm):
    """Every JAX leaf reaches the port and comes back bit for bit through
    the JAX package's converter, and the port's ``state_dict`` has no
    tensor the JAX tree lacks (strict load)."""
    variables = jax_variables(gates, norm)
    sd = lgca_state_dict_from_jax(variables)
    port = tl.LGCANetV3(output_ch=K, norm=norm, feature_scale=FS, attention_gates=gates)
    port.load_state_dict(sd, strict=True)
    assert set(sd) == set(port.state_dict())
    back = convert_lgca_state_dict({k: v.numpy() for k, v in sd.items()})
    assert all(k.endswith("num_batches_tracked") for k in back["_unmatched_keys"])
    for coll in ("params", "batch_stats"):
        ref = dict(_leaves(variables[coll]))
        got = dict(_leaves(back[coll]))
        assert set(got) == set(ref), coll
        for path, v in ref.items():
            assert got[path].dtype == v.dtype and got[path].shape == v.shape, path
            np.testing.assert_array_equal(got[path], v, err_msg=str(path))


def test_load_into_skips_the_dead_upstream_keys():
    """An upstream LGCA ``.pth`` carries ``context_net.forw4.*`` (defined,
    never called) and the attention ``w_q``/``w_k`` linears (their use is
    commented out): ``load_into`` loads the rest and returns exactly those,
    the keys the JAX converter leaves unmatched; a ``.pth`` missing a
    tensor of the model raises."""
    variables = jax_variables(True, "BatchNorm2d")
    sd = lgca_state_dict_from_jax(variables)
    dead = {"context_net.forw4.0.conv1.weight": torch.zeros(64, 64, 3, 3, 3),
            "context_net.forw4.0.conv1.bias": torch.zeros(64),
            "unet.self_attention1.att_layer_0.w_q.weight": torch.zeros(4, 4),
            "unet.self_attention3.att_layer_2.w_k.bias": torch.zeros(4)}
    port = tl.LGCANetV3(output_ch=K, norm="BatchNorm2d", feature_scale=FS,
                        attention_gates=True)
    extra = load_into(port, {**sd, **dead})
    assert sorted(extra) == sorted(dead)
    for k, v in port.state_dict().items():
        assert torch.equal(v, sd[k]), k
    unmatched = convert_lgca_state_dict({k: v.numpy() for k, v in {**sd, **dead}.items()}
                                        )["_unmatched_keys"]
    assert sorted(k for k in unmatched if not k.endswith("num_batches_tracked")) == sorted(dead)
    with pytest.raises(ValueError, match="does not cover"):
        load_into(port, {k: v for k, v in sd.items() if "Att2.psi" not in k})


def test_restore_checkpoint_names_the_model(tmp_path):
    """``restore_checkpoint`` serves either model: a checkpoint with no
    tensor of the model it is given raises, naming that model."""
    from rpnet_tpu_torch.train.checkpoint import restore_checkpoint
    from rpnet_tpu_torch.train.trainer import make_optimizer

    port = tl.LGCANetV3(output_ch=K, feature_scale=FS)
    path = str(tmp_path / "rpnet.pth")
    torch.save({"epoch": 1, "state_dict": {"encoder.Conv1.conv.0.weight": torch.zeros(1)}}, path)
    with pytest.raises(ValueError, match="wrong checkpoint for LGCANetV3"):
        restore_checkpoint(path, port, make_optimizer(port.parameters(), {}), 1)
