"""Both packages' train CLIs with ``net: LGCANet_V3`` on one synthetic
dataset (the eval CLIs: ``test_torch_lgca_eval_cli.py``, with this module's
helpers).

Two train and one eval volume of 16×32×32 (Liver and Spleen; the third ROI,
Kidney L, has no file, so its masks are empty and its eval Dice is None),
a working shape of 32×32×32, 4 slices a step, ``feature_scale`` 8:

  * train: the JAX CLI and the port's (``--platform cpu``) train one epoch
    of 2 volumes (AdamW at lr 1e-5: the second step's loss carries the
    first update, and the f32 gradients of 4-slice batch statistics differ
    by a few percent between the packages, as for RP_Net in
    ``test_torch_train_cli.py``) from the same random weights written as a
    ``.pth`` (``ckpt:``); the same seed draws the same slices, so the epoch
    loss lines agree to 1e-4 relative; the port's checkpoint is the
    reference's file with the upstream LGCA names, and the port's CLI resumes
    from it at the next epoch;
  * a ``mesh_shape`` that needs more devices than the process has, refused
    by the port's eval CLI with the JAX resolver's message (the train CLI's
    refusal is held in ``test_torch_train_cli.py``; a 1-device mesh runs,
    ``test_torch_parallel.py``).

The JAX CLIs see one of the suite's 8 virtual CPU devices (``jax.
local_devices`` patched, ``one_jax_device``): with more they take their mesh
branch, whose sharded step is numerically the single-device step
(``tests/test_lgca.py``) and compiles for over a minute here. The JAX train
step's trace and compile take most of this module's ~45 s.
"""

import re
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from rpnet_tpu.cli import train as jax_train_cli
from rpnet_tpu.core.synthetic import generate_dataset
from rpnet_tpu.models import lgca as jl
from rpnet_tpu_torch.cli import test_rpnet as torch_eval_cli
from rpnet_tpu_torch.cli import train as torch_train_cli
from rpnet_tpu_torch.train.convert import lgca_state_dict_from_jax

from test_torch_lgca import random_lgca_variables

torch.set_num_threads(2)   # small shapes; the suite runs several workers on one machine

ROIS = ["Liver", "Spleen", "Kidney L"]
_EPOCH = re.compile(r"^epoch (\d+) loss (\S+) \(")
_VOLUME = re.compile(r"^(\d+) (\S+) Liver (\S+) Spleen (\S+) Kidney L (\S+)$")


def _config(paths, out_dir, ckpt):
    return dict(
        data_dir=paths["data_dir"], train_set_name=paths["train_csv"],
        eval_set_name=paths["test_csv"], num_slice=16, num_x=32, num_y=32,
        HU_range=[-1024, 3072], net="LGCANet_V3", roi_names=ROIS,
        context_net_downsample_scale=[2, 2, 2], lgca_slices=4, feature_scale=8,
        unet_normalize_type="BatchNorm2d", optimizer="Adam", init_lr=1e-5,
        weight_decay=1e-4, scheduler_step=30, epochs=1, epoch_save=1, n_runs=1,
        out_dir=out_dir, ckpt=ckpt, seed=3)


def _run(cli, tmp_path, name, cfg, extra=()):
    ypath = str(tmp_path / f"{name}.yml")
    with open(ypath, "w") as f:
        yaml.safe_dump(cfg, f)
    stdout = sys.stdout
    try:
        return cli.main(["--yaml", ypath, *extra])
    finally:
        sys.stdout = stdout   # the JAX CLI leaves its log tee installed


def _lines(path, pattern):
    with open(path) as f:
        return [m.groups() for m in map(pattern.match, f) if m]


@pytest.fixture
def one_jax_device(monkeypatch):
    one = jax.local_devices()[:1]
    monkeypatch.setattr(jax, "local_devices", lambda *a, **k: one)


def dataset_and_weights(tmp_path):
    """The synthetic set and a ``.pth`` of random LGCA weights."""
    paths = generate_dataset(str(tmp_path / "data"), n_train=2, n_test=1,
                             shape=(16, 32, 32), seed=0)
    volume = np.zeros((1, 16, 16, 16, 1), np.float32)
    slices = np.zeros((4, 32, 32, 1), np.float32)
    variables = random_lgca_variables(
        jl.LGCANetV3(output_ch=len(ROIS), feature_scale=8), volume, slices, seed=2)
    shared = str(tmp_path / "shared.pth")
    torch.save({"epoch": 0, "state_dict": lgca_state_dict_from_jax(variables)}, shared)
    return paths, shared


@pytest.mark.usefixtures("one_jax_device")
def test_lgca_train_cli_parity(tmp_path):
    paths, shared = dataset_and_weights(tmp_path)
    res = {}
    for name, cli, extra in (("jax", jax_train_cli, ()),
                             ("torch", torch_train_cli, ("--platform", "cpu"))):
        res[name] = _run(cli, tmp_path, f"train_{name}",
                         _config(paths, str(tmp_path / f"train_{name}"), shared), extra)
    jloss = _lines(str(tmp_path / "train_jax" / "log_train"), _EPOCH)
    tloss = _lines(str(tmp_path / "train_torch" / "log_train"), _EPOCH)
    assert [e for e, _ in tloss] == [e for e, _ in jloss] == ["0"]
    port = res["torch"]
    assert len(port["step_losses"]) == 2 and np.isfinite(port["step_losses"]).all()
    np.testing.assert_allclose(float(tloss[0][1]), float(jloss[0][1]), rtol=1e-4)
    np.testing.assert_allclose(port["epoch_losses"][0], float(jloss[0][1]), rtol=1e-4)

    ckpt = port["checkpoint"]
    assert ckpt.endswith("model/epoch_000.pth")
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)
    assert saved["epoch"] == 1 and set(saved) == {"epoch", "state_dict", "optimizer"}
    assert "context_net.forw1.0.shortcut.0.weight" in saved["state_dict"]

    resumed = _run(torch_train_cli, tmp_path, "resume",
                   dict(_config(paths, str(tmp_path / "resume"), ckpt), epochs=2),
                   ("--platform", "cpu"))
    assert _lines(str(tmp_path / "resume" / "log_train"), _EPOCH)[0][0] == "1"
    assert len(resumed["step_losses"]) == 2 and resumed["checkpoint"].endswith("epoch_001.pth")


def test_lgca_eval_cli_refuses_a_mesh(tmp_path):
    from rpnet_tpu.parallel.mesh import resolve_local_mesh

    with pytest.raises(ValueError) as jax_err:
        resolve_local_mesh({"data": 2}, devices=jax.devices()[:1])
    paths = generate_dataset(str(tmp_path / "data"), n_train=1, n_test=1,
                             shape=(16, 32, 32), seed=0)
    cfg = dict(_config(paths, str(tmp_path / "out"), None), mesh_shape={"data": 2})
    with pytest.raises(ValueError) as err:
        _run(torch_eval_cli, tmp_path, "mesh", cfg, ("--platform", "cpu"))
    assert str(err.value) == str(jax_err.value) == (
        "mesh shape {'data': 2, 'model': 1} needs 2 devices, have 1")
