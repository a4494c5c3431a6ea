"""rpnet_tpu_torch's U-Net ``unet_normalize_type`` InstanceNorm2d and
GroupNorm (``models/blocks.py``) vs the JAX ``Norm2d``
(``rpnet_tpu/models/blocks.py:62-82``), same weights:

  * one SGD step of RP_Net with each norm against the JAX trainer
    (``test_torch_train_breadth.py``'s helpers, shapes and tolerances: loss
    1e-4 relative, each tensor's change 10%, running statistics 2e-3 of
    their scale; conv biases an instance norm cancels, 1e-4 absolute);
  * the U-Net encoder's eval forward at 32² (2e-4, the encoder's
    tolerance), the bridge loading strictly and, for InstanceNorm2d, the
    JAX ``convert_state_dict`` inverting it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpnet_tpu.models.unet import UNet as JaxUNet
from rpnet_tpu.train.convert import convert_state_dict
from rpnet_tpu_torch.models.unet import UNet
from rpnet_tpu_torch.train.convert import state_dict_from_jax

from test_torch_backbones import he_kernels, random_variables
from test_torch_train_breadth import H, _t, check_step

torch.set_num_threads(2)   # small shapes; the suite runs several workers on one machine


@pytest.mark.parametrize("case", ["instance_norm", "group_norm"])
def test_step_matches_jax(case):
    check_step(case)


@pytest.mark.parametrize("norm", ["InstanceNorm2d", "GroupNorm"])
def test_unet_norms_eval_forward_and_bridge(norm):
    """The U-Net encoder's eval forward with ``unet_normalize_type`` against
    the JAX ``UNet(norm=...)`` at 32² (2e-4, the encoder's tolerance); the
    bridge loads strictly (GroupNorm's scale and bias in the norm slot,
    InstanceNorm2d without tensors) and, for InstanceNorm2d, the JAX
    ``convert_state_dict`` inverts it; zeroing the GroupNorm's bias moves
    the output."""
    jmod = JaxUNet(norm=norm)
    x = np.random.RandomState(3).randn(2, H, H, 1).astype(np.float32)
    variables = random_variables(jmod, jnp.zeros((1, H, H, 1)), train=False, seed=4)
    variables["params"] = he_kernels(variables["params"], seed=5)
    ref = np.asarray(jax.jit(lambda v, a: jmod.apply(v, a, train=False)["d4"])(
        variables, x))
    port = UNet(norm=norm).eval()
    sd = {k[len("encoder."):]: v for k, v in
          state_dict_from_jax({"params": {"encoder": variables["params"]},
                               "batch_stats": {}}).items()}
    port.load_state_dict(sd, strict=True)
    norm_keys = [k for k in sd if ".conv.1." in k or ".conv.4." in k or ".up.2." in k]
    assert len(norm_keys) == (2 * 16 if norm == "GroupNorm" else 0)   # 16 norms
    with torch.no_grad():
        out = port(_t(x)).numpy()
    assert out.shape == ref.shape == (2, H // 4, H // 4, 256)
    np.testing.assert_allclose(out, ref, atol=2e-4)
    if norm == "InstanceNorm2d":
        back = convert_state_dict({f"encoder.{k}": v.numpy() for k, v in sd.items()})
        again = state_dict_from_jax({"params": back["params"], "batch_stats": {}})
        assert set(again) == {f"encoder.{k}" for k in sd}
        for k, v in again.items():
            np.testing.assert_array_equal(v.numpy(), sd[k[len("encoder."):]].numpy())
    else:
        with torch.no_grad():
            port.Up_conv4.conv[4].bias.zero_()
            assert np.abs(port(_t(x)).numpy() - out).max() > 50 * 2e-4
