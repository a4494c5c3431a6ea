"""rpnet_tpu_torch's ``LGCANetV3`` eval forward vs the JAX package's, same
weights (``test_torch_lgca.py``'s sizes and random variables), f32 on the
CPU: U_Net and AttU_Net with BatchNorm2d and InstanceNorm2d, and U_Net with
GroupNorm (AttU_Net's one-channel psi norm cannot take GroupNorm's 8
groups: both packages refuse it). ``seg_2d`` and ``dsv`` within 5e-4 of
their largest magnitude, the loss's per-class terms within 1e-5. Each JAX
forward is jitted (~5 s a case; eager op by op takes longer cold).
"""

import jax
import numpy as np
import pytest
import torch

from rpnet_tpu.models import lgca as jl
from rpnet_tpu_torch.models import lgca as tl

from test_torch_lgca import B, CASES, D, FS, H, K, _t, inputs, jax_variables, port_model

torch.set_num_threads(2)   # small shapes; the suite runs several workers on one machine


@pytest.mark.parametrize("gates,norm", CASES + [(True, "GroupNorm")])
def test_lgcanet_forward_matches_jax(gates, norm):
    if norm == "GroupNorm" and gates:
        # the AttU_Net gate's psi norm has one channel: 8 groups cannot split it
        volume, slices = inputs()[:2]
        jmodel = jl.LGCANetV3(output_ch=K, norm=norm, feature_scale=FS, attention_gates=True)
        with pytest.raises(ValueError):
            jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), volume, slices))
        with pytest.raises(ValueError):
            tl.LGCANetV3(output_ch=K, norm=norm, feature_scale=FS, attention_gates=True)
        return
    variables = jax_variables(gates, norm)
    volume, slices, mask, vmask = inputs()
    model = jl.LGCANetV3(output_ch=K, norm=norm, feature_scale=FS, attention_gates=gates)
    out = jax.jit(lambda v, a, b: model.apply(v, a, b, train=False))(variables, volume, slices)
    ref_loss = jl.LGCANetV3.loss(out, {"mask": mask, "downsampled_volume_mask": vmask})
    ref = {k: np.asarray(v) for k, v in out.items()}
    port = port_model(variables, gates, norm)
    with torch.no_grad():
        out = port(_t(volume), _t(slices))
        losses = tl.LGCANetV3.loss(out, {"mask": _t(mask), "downsampled_volume_mask": _t(vmask)})
    assert tuple(out["seg_2d"].shape) == ref["seg_2d"].shape == (B, H, H, K)
    assert tuple(out["dsv"].shape) == ref["dsv"].shape == (1, D, H // 2, H // 2, K)
    for k in ("seg_2d", "dsv"):
        np.testing.assert_allclose(out[k].numpy(), ref[k], atol=5e-4 * np.abs(ref[k]).max(),
                                   err_msg=k)
    assert losses["unet_dice"][1] == 0          # no ground truth in the slices
    for k in ("unet_dice", "loss_dice"):
        assert losses[k].shape == (K,)
        np.testing.assert_allclose(losses[k].numpy(), np.asarray(ref_loss[k]), atol=1e-5,
                                   err_msg=k)
