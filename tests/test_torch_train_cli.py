"""Both train CLIs end to end on one synthetic dataset and one ``.pth``.

The JAX CLI and the port's (``--platform cpu``) train one epoch of 2 steps
(batch_size 2, k=2, 32², U-Net d4, r=2, 1 soft-mask refinement iteration
(the JAX CLI unrolls the refinement, so each one adds to its compile),
AdamW at the example's lr 1e-5, gamma jitter on, no registration prior —
``test_torch_train_steps.py`` covers the step with it) from the same
JAX-initialized weights written as a ``.pth`` (``ckpt:``). The same seed
draws the same episodes in both, so the epoch loss lines agree to 1e-4
relative (the step's f32 gradients differ by a few percent at these tiny
batches, ``test_torch_train.py::test_sgd_step_matches``, which moves the
second step's loss by less than that at lr 1e-5). The port's checkpoint
converts back through the JAX package's ``convert_state_dict`` and resumes
the port's CLI at the next epoch. The port's ``pretrained_path`` warm
starts and its TensorBoard scalar are held here too: the JAX CLI has
already imported TensorBoard (and the TensorFlow it finds) in this worker.
"""

import re
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from rpnet_tpu.cli import train as jax_cli
from rpnet_tpu.core.synthetic import generate_dataset
from rpnet_tpu.train.convert import convert_state_dict
from rpnet_tpu_torch.cli import train as torch_cli
from rpnet_tpu_torch.train.convert import state_dict_from_jax

from test_torch_models import jax_rpnet, tensorboard_without_tensorflow  # noqa: F401

torch.set_num_threads(2)   # small shapes; the suite runs several workers on one machine

# every CLI run of this module writes TensorBoard without TensorFlow
pytestmark = pytest.mark.usefixtures("tensorboard_without_tensorflow")

_EPOCH = re.compile(r"^epoch (\d+) loss (\S+) \(")


def _config(paths, out_dir, ckpt):
    return dict(
        data_dir=paths["data_dir"], class_csv_dir=paths["class_dir"],
        train_set_name=paths["train_csv"], eval_set_name=paths["test_csv"],
        num_slice=32, num_x=48, num_y=48, crop_size=[32, 32], pad_value=-1024,
        HU_range=[-1024, 3072], n_shot=1, n_way=1, k=2,
        train_classes=["Liver", "Spleen"], eval_classes=["Liver"],
        backbone="UNet", n_iter_refinement=2, mask_refinement_correlation_radius=2,
        soft_mask=True, use_registration_loss=False, do_deformable=False,
        do_intaug=True, batch_size=2, optimizer="Adam", init_lr=1e-5,
        weight_decay=1e-4, scheduler_step=30, epochs=1, epoch_save=1,
        loss="dice_ce", align_loss_scaler=1.0, out_dir=out_dir, ckpt=ckpt,
        use_native_io=False, seed=3)


def _epoch_losses(path):
    with open(path) as f:
        return [(int(m.group(1)), float(m.group(2)))
                for m in map(_EPOCH.match, f) if m]


def test_train_cli_parity(tmp_path):
    paths = generate_dataset(str(tmp_path / "data"), n_train=2, n_test=1,
                             shape=(16, 48, 48), seed=0)
    _, variables = jax_rpnet(radius=2, num_iter=2, size=32, seed=4)
    ckpt = str(tmp_path / "shared.pth")
    torch.save({"epoch": 0, "state_dict": state_dict_from_jax(variables)}, ckpt)

    results = {}
    for name, cli, extra in (("jax", jax_cli, []),
                             ("torch", torch_cli, ["--platform", "cpu"])):
        out = str(tmp_path / name)
        ypath = str(tmp_path / f"{name}.yml")
        with open(ypath, "w") as f:
            yaml.safe_dump(dict(_config(paths, out, ckpt), n_iter_refinement=1), f)
        stdout = sys.stdout
        try:
            results[name] = cli.main(["--yaml", ypath, "--episodes-per-epoch", "4"] + extra)
        finally:
            sys.stdout = stdout   # the JAX CLI leaves its log tee installed
    assert sys.stdout is stdout

    jl = _epoch_losses(str(tmp_path / "jax" / "log_train"))
    tl = _epoch_losses(str(tmp_path / "torch" / "log_train"))
    assert [e for e, _ in tl] == [e for e, _ in jl] == [0]
    np.testing.assert_allclose(tl[0][1], jl[0][1], rtol=1e-4)
    res = results["torch"]
    assert len(res["step_losses"]) == 2 and np.isfinite(res["step_losses"]).all()
    np.testing.assert_allclose(res["epoch_losses"][0], jl[0][1], rtol=1e-4)

    # the port's checkpoint: the reference's layout, convertible by the JAX
    # package, resumable by the port
    saved = torch.load(res["checkpoint"], map_location="cpu", weights_only=True)
    assert saved["epoch"] == 1 and set(saved) == {"epoch", "state_dict", "optimizer"}
    tree = convert_state_dict({k: v.numpy() for k, v in saved["state_dict"].items()},
                              variables)
    back = state_dict_from_jax({"params": tree["params"], "batch_stats": tree["batch_stats"]})
    for k, v in back.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(v.numpy(), saved["state_dict"][k].numpy(), err_msg=k)

    cfg = dict(_config(paths, str(tmp_path / "resume"), res["checkpoint"]),
               n_iter_refinement=1, epochs=2)
    ypath = str(tmp_path / "resume.yml")
    with open(ypath, "w") as f:
        yaml.safe_dump(cfg, f)
    resumed = torch_cli.main(["--yaml", ypath, "--platform", "cpu",
                              "--episodes-per-epoch", "4"])
    assert [e for e, _ in _epoch_losses(str(tmp_path / "resume" / "log_train"))] == [1]
    assert len(resumed["step_losses"]) == 2 and resumed["checkpoint"].endswith("epoch_001.pth")


def _cli_config(paths, out_dir, **kw):
    cfg = dict(_config(paths, out_dir, None), n_iter_refinement=1,
               mask_refinement_correlation_radius=1, epochs=1)
    cfg.update(kw)
    return cfg


@pytest.mark.parametrize("backbone", ["vgg", "UNet"])
def test_train_cli_pretrained_path_and_tensorboard(tmp_path, monkeypatch, backbone):
    """The port's train CLI with ``pretrained_path``: a seeded torchvision
    VGG16 state dict for ``backbone: vgg`` (the encoder's 13 convs), a full
    RP_Net ``.pth`` for the U-Net; the first step starts from those weights
    (the model the step sees carries them), and the epoch's loss is written
    to TensorBoard under ``out_dir/runs``."""
    from rpnet_tpu_torch.models.factory import build_rpnet
    from rpnet_tpu_torch.train.convert import convert_torchvision_vgg16

    from test_torch_train_breadth import torchvision_vgg16

    dataset = generate_dataset(str(tmp_path / "data"), n_train=2, n_test=1,
                               shape=(16, 48, 48), seed=0)
    if backbone == "vgg":
        warm = tmp_path / "vgg16.pth"
        torch.save(torchvision_vgg16(2), warm)
        expect = convert_torchvision_vgg16(torchvision_vgg16(2))
        kw = dict(backbone="vgg", scale=8)
    else:
        warm = tmp_path / "rpnet.pth"
        kw = dict(backbone="UNet", scale=4)
        source = build_rpnet(_cli_config(dataset, "", **kw), num_iter=1, seed=11)
        torch.save({"epoch": 3, "state_dict": source.state_dict()}, warm)
        expect = source.state_dict()
    seen = {}
    real = torch_cli.make_train_step

    def spy(model, config, optimizer):   # the weights the first step starts from
        seen.update({k: v.clone() for k, v in model.state_dict().items()})
        return real(model, config, optimizer)

    monkeypatch.setattr(torch_cli, "make_train_step", spy)
    out = tmp_path / "out"
    ypath = tmp_path / "cfg.yml"
    with open(ypath, "w") as f:
        yaml.safe_dump(_cli_config(dataset, str(out), pretrained_path=str(warm), **kw), f)
    res = torch_cli.main(["--yaml", str(ypath), "--platform", "cpu",
                          "--episodes-per-epoch", "2"])
    assert len(res["step_losses"]) == 1 and np.isfinite(res["step_losses"]).all()
    for k, v in expect.items():
        if v.is_floating_point():
            assert torch.equal(seen[k], v), k
    with open(out / "log_train") as f:
        log = f.read()
    assert f"[{'vgg' if backbone == 'vgg' else 'UNet'} warm start from {warm}]" in log
    assert "[tensorboard: train/loss per epoch under" in log
    events = list((out / "runs").glob("events.out.tfevents.*"))
    assert len(events) == 1 and events[0].stat().st_size > 0


def test_train_cli_refuses_to_fall_back_to_cpu(tmp_path, monkeypatch):
    """--platform gpu (the default) raises without a GPU; never a CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_cli.main(["--yaml", str(tmp_path / "unused.yml")])


@pytest.mark.parametrize("key,value", [("net", "LGCANet_V3"),
                                       ("unet_normalize_type", "LayerNorm"),
                                       ("optimizer", "rmsprop")])
def test_train_step_refuses_what_is_not_ported(key, value, tmp_path):
    """What the port's training refuses as the JAX package does: LGCANet_V3
    with a ``mesh_shape`` that needs more devices than the process has (the
    JAX resolver's message; a 1-device mesh trains,
    ``test_torch_parallel.py``), a ``unet_normalize_type`` its ``Norm2d``
    does not know and an optimizer its ``make_optimizer`` does not know."""
    from rpnet_tpu.models.blocks import Norm2d
    from rpnet_tpu.train.trainer import make_optimizer as jax_make_optimizer
    from rpnet_tpu_torch.models.factory import build_rpnet
    from rpnet_tpu_torch.train.trainer import make_optimizer

    cfg = {key: value}
    if key == "net":
        from rpnet_tpu.parallel.mesh import resolve_local_mesh

        with pytest.raises(ValueError) as jax_err:
            resolve_local_mesh({"data": 2}, devices=jax.devices()[:1], batch_divisor=4)
        paths = generate_dataset(str(tmp_path / "data"), n_train=1, n_test=1,
                                 shape=(16, 32, 32), seed=0)
        ypath = str(tmp_path / "lgca.yml")
        with open(ypath, "w") as f:
            yaml.safe_dump(dict(cfg, mesh_shape={"data": 2}, out_dir=str(tmp_path / "out"),
                                data_dir=paths["data_dir"], train_set_name=paths["train_csv"],
                                num_slice=16, num_x=32, num_y=32, roi_names=["Liver"],
                                lgca_slices=4, feature_scale=8), f)
        stdout = sys.stdout
        try:
            with pytest.raises(ValueError) as err:
                torch_cli.main(["--yaml", ypath, "--platform", "cpu"])
        finally:
            sys.stdout = stdout
        assert str(err.value) == str(jax_err.value) == (
            "mesh shape {'data': 2, 'model': 1} needs 2 devices, have 1")
    elif key == "unet_normalize_type":
        with pytest.raises(NotImplementedError, match="LayerNorm"):
            Norm2d(value).init(jax.random.PRNGKey(0), np.zeros((1, 4, 4, 8), np.float32))
        with pytest.raises(NotImplementedError, match="LayerNorm"):
            build_rpnet(cfg, num_iter=1)
    else:
        with pytest.raises(NotImplementedError, match="rmsprop"):
            jax_make_optimizer(cfg)
        model = build_rpnet({"mask_refinement_correlation_radius": 1}, num_iter=1)
        with pytest.raises(NotImplementedError, match="rmsprop"):
            make_optimizer(model.parameters(), cfg)


def test_train_cli_runs_deformable(tmp_path):
    """The port's train CLI with ``do_deformable: True`` (3 demons steps at
    ``reg_fit_scale`` 2) under both structures: one finite step each, and
    losses that differ (the structure reaches the prior; the step itself is
    held against the JAX trainer in ``test_torch_train_steps.py``)."""
    paths = generate_dataset(str(tmp_path / "data"), n_train=2, n_test=1,
                             shape=(16, 48, 48), seed=0)
    first = {}
    for sampler in ("matmul", "gather"):
        cfg = dict(_config(paths, str(tmp_path / sampler), None), use_registration_loss=True,
                   do_deformable=True, reg_demons_iters=3, reg_affine_iters=4,
                   reg_fit_scale=2, reg_sampler=sampler)
        ypath = str(tmp_path / f"{sampler}.yml")
        with open(ypath, "w") as f:
            yaml.safe_dump(cfg, f)
        res = torch_cli.main(["--yaml", ypath, "--platform", "cpu", "--episodes-per-epoch", "2"])
        assert len(res["step_losses"]) == 1 and np.isfinite(res["step_losses"]).all()
        first[sampler] = res["step_losses"][0]
    assert abs(first["matmul"] - first["gather"]) > 1e-6
