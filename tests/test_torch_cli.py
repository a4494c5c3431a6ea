"""Both eval CLIs end to end on one synthetic dataset and one ``.pth``.

The JAX CLI (``reg_sampler: gather``, its torch-exact fit) and the port's CLI
(``--platform cpu``) run the same YAML with ``compute_dtype: float32``:
the same seed draws the same supports, so the per-episode log lines agree
in everything but the last digits, and the per-class affine, fewshot and
per-iteration Dice of ``results_eval.json`` agree within 1e-3.
"""

import json
import re
import sys

import numpy as np
import pytest
import torch
import yaml

from rpnet_tpu.cli import test_rpnet as jax_cli
from rpnet_tpu.core.synthetic import generate_dataset
from rpnet_tpu_torch.cli import test_rpnet as torch_cli
from rpnet_tpu_torch.train.convert import state_dict_from_jax

from test_torch_models import jax_rpnet

_FLOAT = re.compile(r"-?\d+\.\d+(e-?\d+)?")


def _config(paths, out_dir, ckpt, **kw):
    # tests/test_episode.py::small_config, with a checkpoint and f32
    cfg = dict(
        data_dir=paths["data_dir"], class_csv_dir=paths["class_dir"],
        eval_set_name=paths["test_csv"], train_set_name=paths["train_csv"],
        num_slice=32, num_x=48, num_y=48,
        crop_size=[32, 32], pad_value=-1024, HU_range=[-1024, 3072],
        n_shot=1, n_way=1, k=4,
        eval_classes=["Liver"], train_classes=["Spleen"],
        backbone="UNet", n_iter_refinement=2, n_test_iter_refinement=2,
        mask_refinement_correlation_radius=2, soft_mask=False,
        use_registration_loss=True, use_registration_mask=True,
        do_deformable=False, reg_affine_iters=8,
        slice_bucket=8, max_slices=32, do_intaug=False, do_elastic=False,
        n_runs=1, out_dir=out_dir, ckpt=ckpt, compute_dtype="float32",
        num_workers=0)
    cfg.update(kw)
    return cfg


def _episode_lines(path):
    with open(path) as f:
        lines = [l.rstrip() for l in f]
    keep = [l for l in lines if re.match(r"^\d+ syn\d+ syn\d+ affine ", l)
            or l.startswith("Liver, affine") or l.startswith("ref 0 ")]
    return [_FLOAT.sub("#", l) for l in keep]


def test_cli_parity(tmp_path):
    paths = generate_dataset(str(tmp_path / "data"), n_train=3, n_test=3,
                             shape=(20, 48, 48), seed=0)
    _, variables = jax_rpnet(radius=2, num_iter=2, size=32, seed=3)
    ckpt = str(tmp_path / "shared.pth")
    torch.save({"epoch": 0, "state_dict": state_dict_from_jax(variables)}, ckpt)

    results = {}
    for name, cli, extra, kw in (
            ("jax", jax_cli, [], dict(reg_sampler="gather")),
            ("torch", torch_cli, ["--platform", "cpu"], {})):
        out = str(tmp_path / name)
        ypath = str(tmp_path / f"{name}.yml")
        with open(ypath, "w") as f:
            yaml.safe_dump(_config(paths, out, ckpt, **kw), f)
        stdout = sys.stdout
        try:
            results[name] = cli.main(["--yaml", ypath] + extra)
        finally:
            sys.stdout = stdout   # the JAX CLI leaves its log tee installed
        with open(f"{out}/results_eval.json") as f:
            results[name + "_json"] = json.load(f)

    j, t = results["jax_json"], results["torch_json"]
    assert set(t) >= {"classes", "wall_time_sec", "episodes", "failed_episodes",
                      "episodes_per_sec"}
    assert t["episodes"] == j["episodes"] == 3
    assert t["failed_episodes"] == j["failed_episodes"] == 0
    jc, tc = j["classes"]["Liver"], t["classes"]["Liver"]
    assert set(tc["refinement"]) == set(jc["refinement"]) == {"0", "1"}
    for key in ("affine", "fewshot"):
        np.testing.assert_allclose(tc[key], jc[key], atol=1e-3, err_msg=key)
    for it in jc["refinement"]:
        np.testing.assert_allclose(tc["refinement"][it], jc["refinement"][it],
                                   atol=1e-3, err_msg=f"ref {it}")

    jl = _episode_lines(str(tmp_path / "jax" / "log_eval"))
    tl = _episode_lines(str(tmp_path / "torch" / "log_eval"))
    assert len(jl) == 6   # 3 episodes; the pass and aggregate class lines; ref line
    assert tl == jl


def test_cli_refuses_to_fall_back_to_cpu(tmp_path, monkeypatch):
    """--platform gpu (the default) raises without a GPU; never a CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_cli.main(["--yaml", str(tmp_path / "unused.yml")])
