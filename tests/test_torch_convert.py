"""The weight bridge: rpnet_tpu_torch.train.convert.state_dict_from_jax is
inverted exactly by the JAX package's own convert_state_dict, and its output
loads into the port's model with strict=True."""

import numpy as np
import pytest
import torch

from rpnet_tpu.train.convert import convert_state_dict
from rpnet_tpu_torch.models.rpnet import RPNet
from rpnet_tpu_torch.train.convert import (load_into, load_torch_checkpoint,
                                           state_dict_from_jax)

from test_torch_models import jax_rpnet

torch.set_num_threads(2)   # small shapes; the suite runs several workers on one machine


@pytest.fixture(scope="module")
def jax_variables():
    return jax_rpnet(radius=2, num_iter=1, size=32)[1]


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_jax_converter_inverts_the_bridge(jax_variables):
    back = convert_state_dict(state_dict_from_jax(jax_variables))
    for part in ("params", "batch_stats"):
        want = dict(_flat(jax_variables[part]))
        got = dict(_flat(back[part]))
        assert set(got) == set(want), part
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    # only the BN step counters have no JAX counterpart
    assert all(k.endswith("num_batches_tracked") for k in back["_unmatched_keys"])


def test_port_model_loads_bridge_strictly(jax_variables):
    model = RPNet(radius=2, num_iter=1)
    sd = state_dict_from_jax(jax_variables)
    model.load_state_dict(sd, strict=True)
    assert set(sd) == set(model.state_dict())
    # the fused 1×1 conv is [corr; fm] along the input channels
    q = jax_variables["params"]["cre"]
    w = model.state_dict()["cre.q.0.weight"].numpy()
    np.testing.assert_array_equal(
        w[:, :25, 0, 0], q["q_conv_corr"]["conv"]["kernel"][0, 0].T)
    np.testing.assert_array_equal(
        w[:, 25:, 0, 0], q["q_conv_fm"]["conv"]["kernel"][0, 0].T)


def test_pth_round_trip_skips_upstream_extras(jax_variables, tmp_path):
    """A reference-style {'epoch', 'state_dict'} .pth with the upstream
    modules the port does not build loads; a missing tensor raises."""
    sd = state_dict_from_jax(jax_variables)
    extra = {"encoder.Up3.up.1.weight": torch.zeros(1),
             "cre.w_context.0.weight": torch.zeros(1)}
    path = str(tmp_path / "ck.pth")
    torch.save({"epoch": 3, "state_dict": {**sd, **extra}}, path)
    ck = load_torch_checkpoint(path)
    assert ck["epoch"] == 3
    model = RPNet(radius=2, num_iter=1)
    assert sorted(load_into(model, ck["state_dict"])) == sorted(extra)
    np.testing.assert_array_equal(model.state_dict()["cre.w_q.1.running_var"].numpy(),
                                  sd["cre.w_q.1.running_var"].numpy())
    del sd["encoder.Conv3.conv.4.running_mean"]
    with pytest.raises(ValueError, match="does not cover"):
        load_into(RPNet(radius=2, num_iter=1), sd)
