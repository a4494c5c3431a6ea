"""Both packages' eval CLIs with ``net: LGCANet_V3`` on the port's own
checkpoint.

The port's train CLI trains one epoch of ``test_torch_lgca_cli.py``'s
dataset (two train and one eval volume of 16×32×32, Liver and Spleen, and
Kidney L with no file) from its random weights; both eval CLIs load the
written ``.pth`` (the JAX package's ``restore_into`` converts it) and
segment the eval volume in 2 chunks of 16 slices: the same volume line, each
ROI's Dice within 1e-3, None for Kidney L in both, ``results_eval.json``
with every ROI. The JAX CLI sees one CPU device (``one_jax_device``).
"""

import json

import numpy as np
import pytest
import torch

from rpnet_tpu.cli import test_rpnet as jax_eval_cli
from rpnet_tpu_torch.cli import test_rpnet as torch_eval_cli
from rpnet_tpu_torch.cli import train as torch_train_cli

from test_torch_lgca_cli import (_VOLUME, ROIS, _config, _lines, _run,  # noqa: F401
                                 dataset_and_weights, one_jax_device)

torch.set_num_threads(2)   # small shapes; the suite runs several workers on one machine


@pytest.mark.usefixtures("one_jax_device")
def test_lgca_eval_cli_parity(tmp_path):
    paths, shared = dataset_and_weights(tmp_path)
    ckpt = _run(torch_train_cli, tmp_path, "train",
                _config(paths, str(tmp_path / "train"), shared),
                ("--platform", "cpu"))["checkpoint"]
    results, lines = {}, {}
    for name, cli, extra in (("jax", jax_eval_cli, ()),
                             ("torch", torch_eval_cli, ("--platform", "cpu"))):
        out = tmp_path / f"eval_{name}"
        results[name] = _run(cli, tmp_path, f"eval_{name}", _config(paths, str(out), ckpt),
                             extra)
        lines[name] = _lines(str(out / "log_eval"), _VOLUME)
        with open(out / "results_eval.json") as f:
            assert set(json.load(f)["classes"]) == set(ROIS)
    assert len(lines["torch"]) == len(lines["jax"]) == 1
    (j, pid, *dices), = lines["torch"]
    (jj, jpid, *jdices), = lines["jax"]
    assert (j, pid) == (jj, jpid)
    assert dices[2] == jdices[2] == "None"               # no Kidney L in the set
    for a, b in zip(dices[:2], jdices[:2]):
        assert abs(float(a) - float(b)) < 1e-3, (dices, jdices)
    for roi in ROIS[:2]:
        a = results["torch"]["classes"][roi]["dice"][0]
        assert abs(a - results["jax"]["classes"][roi]["dice"][0]) < 1e-3
    assert np.isnan(results["torch"]["classes"]["Kidney L"]["dice"][0])
    assert results["torch"]["failed_volumes"] == 0 and results["torch"]["volumes"] == 1
