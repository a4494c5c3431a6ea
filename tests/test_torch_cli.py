"""Both eval CLIs end to end on one synthetic dataset and one ``.pth``.

The JAX CLI (``reg_sampler: gather``, its torch-exact fit) and the port's CLI
(``--platform cpu``) run the same YAML with ``compute_dtype: float32``:
the same seed draws the same supports, so the per-episode log lines agree
in everything but the last digits, and the per-class affine, fewshot and
per-iteration Dice of ``results_eval.json`` agree within 1e-3. Both on the
host data path (``device_volume_cache: 0``, ``num_workers: 0``) and on the
defaults (a device volume cache of 16 and index-only episodes; 4 prefetch
workers, unused while the cache is on).
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
        n_runs=1, out_dir=out_dir, ckpt=ckpt, compute_dtype="float32")
    cfg.update(kw)
    return cfg


def _episode_lines(path):
    with open(path) as f:
        lines = [l.rstrip() for l in f]
    keep = [l for l in lines if re.match(r"^\d+ syn\d+ syn\d+ affine ", l)
            or l.startswith("Liver, affine") or l.startswith("ref 0 ")]
    return [_FLOAT.sub("#", l) for l in keep]


@pytest.mark.parametrize("data_path", [dict(device_volume_cache=0, num_workers=0), {}],
                         ids=["num_workers=0", "defaults"])
def test_cli_parity(tmp_path, data_path):
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
            yaml.safe_dump(_config(paths, out, ckpt, **kw, **data_path), f)
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


def test_deformable_eval_matches_jax(tmp_path, capsys, request, monkeypatch):
    """``do_deformable: True`` (4 demons steps). The gather structure: the
    JAX CLI's ``evaluate`` on a JAX runner built directly (its ``main``
    spends ~25 s initializing a model on the host) against the port's CLI
    ``main``: the same per-episode lines (numbers aside), every episode's
    Dice within 1e-3. The matmul structure at ``reg_fit_scale`` 2 (pooled
    fit, upsampled displacement) through the port's CLI: no failure, every
    Dice finite (the JAX package's matmul form takes another affine
    trajectory by design; the structure is held against a JAX oracle and at
    the Dice level in ``test_torch_demons.py``). Both runners integrate with
    4 squarings here: at 10, compiling the JAX fit under its gradient makes
    this test nearly twice as slow, and the 10-squaring integration is held
    in ``test_torch_demons.py``."""
    import functools
    import random

    import rpnet_tpu.episode.pipeline as jax_pipeline
    import rpnet_tpu_torch.episode.pipeline as torch_pipeline

    from rpnet_tpu.config import Config as JaxConfig
    from rpnet_tpu.episode.pipeline import EpisodeRunner as JaxEpisodeRunner
    from rpnet_tpu.episode.sampler import EpisodeSampler as JaxEpisodeSampler

    threads = torch.get_num_threads()
    torch.set_num_threads(2)   # small shapes; the suite runs several workers
    request.addfinalizer(lambda: torch.set_num_threads(threads))
    for mod in (jax_pipeline, torch_pipeline):
        monkeypatch.setattr(mod, "register_episode",
                            functools.partial(mod.register_episode, diffeo_scaling=4))
    paths = generate_dataset(str(tmp_path / "data"), n_train=3, n_test=3,
                             shape=(20, 48, 48), seed=0)
    model, variables = jax_rpnet(radius=2, num_iter=2, size=32, seed=3)
    ckpt = str(tmp_path / "shared.pth")
    torch.save({"epoch": 0, "state_dict": state_dict_from_jax(variables)}, ckpt)
    raw = _config(paths, str(tmp_path / "gather"), ckpt, do_deformable=True,
                  reg_demons_iters=4, reg_sampler="gather")

    jconfig = JaxConfig(raw).replace(n_iter_refinement=raw["n_test_iter_refinement"])
    random.seed(0)
    np.random.seed(0)
    j_aff, _, _, j_fail = jax_cli.evaluate(
        JaxEpisodeRunner(model, variables, jconfig),
        JaxEpisodeSampler(raw["data_dir"], raw["eval_set_name"], jconfig, mode="eval"),
        jconfig)
    jl = [l.rstrip() for l in capsys.readouterr().out.splitlines()
          if re.match(r"^\d+ syn\d+ syn\d+ affine ", l)]

    res = {}
    for name, kw in (("gather", {}), ("matmul", dict(reg_sampler="matmul", reg_fit_scale=2))):
        ypath = str(tmp_path / f"{name}.yml")
        with open(ypath, "w") as f:
            yaml.safe_dump(dict(raw, out_dir=str(tmp_path / name), **kw), f)
        res[name] = torch_cli.main(["--yaml", ypath, "--platform", "cpu"])
        assert res[name]["failed_episodes"] == 0 and res[name]["episodes"] == 3
    assert j_fail == 0
    with open(str(tmp_path / "gather" / "log_eval")) as f:
        tl = [l.rstrip() for l in f if re.match(r"^\d+ syn\d+ syn\d+ affine ", l)]
    assert len(jl) == 3 and [_FLOAT.sub("#", l) for l in tl] == [_FLOAT.sub("#", l) for l in jl]
    # per episode: (ncc_warped, ncc_raw) printed to 4 decimals, then the
    # affine, fewshot, ref 0 and ref 1 Dice
    nums = lambda lines: np.array([[float(m.group()) for m in _FLOAT.finditer(l)]
                                   for l in lines])
    np.testing.assert_allclose(nums(tl)[:, :2], nums(jl)[:, :2], atol=2e-4)
    np.testing.assert_allclose(nums(tl)[:, 2:], nums(jl)[:, 2:], atol=1e-3)
    assert np.abs(nums(jl)[:, 2] - np.array(j_aff["Liver"])).max() < 1e-6
    assert all(np.isfinite(v) for r in res["matmul"]["classes"]["Liver"].values()
               for v in (r if isinstance(r, list) else sum(r.values(), [])))


def test_cli_refuses_to_fall_back_to_cpu(tmp_path, monkeypatch):
    """--platform gpu (the default) raises without a GPU; never a CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_cli.main(["--yaml", str(tmp_path / "unused.yml")])
