"""Both eval CLIs end to end on one synthetic dataset and one ``.pth``.

The JAX CLI (``reg_sampler: gather``, its torch-exact fit) and the port's CLI
(``--platform cpu``) run the same YAML with ``compute_dtype: float32``:
the same seed draws the same supports, so the per-episode log lines agree
in everything but the last digits, and the per-class affine, fewshot and
per-iteration Dice of ``results_eval.json`` agree within 1e-3. The port
runs on the host data path (``device_volume_cache: 0``, ``num_workers:
0``) and on the defaults (a device volume cache of 16 and index-only
episodes; 4 prefetch workers, unused while the cache is on), each held
against one run of the JAX CLI (its episodes and Dice do not depend on the
data path), and the two paths print the same lines. The port's served eval (its
export and serve CLIs) is held against the same JAX run.
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
from rpnet_tpu_torch.cli import export as export_cli
from rpnet_tpu_torch.cli import serve as serve_cli
from rpnet_tpu_torch.cli import test_rpnet as torch_cli
from rpnet_tpu_torch.train.convert import state_dict_from_jax

from test_torch_models import jax_rpnet, tensorboard_without_tensorflow  # noqa: F401

torch.set_num_threads(2)   # small shapes; the suite runs several workers on one machine

# every CLI run of this module writes TensorBoard without TensorFlow
pytestmark = pytest.mark.usefixtures("tensorboard_without_tensorflow")

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


DATA_PATHS = {"num_workers=0": dict(device_volume_cache=0, num_workers=0), "defaults": {}}


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """One dataset and ``.pth``, one run of the JAX CLI, and the port's CLI
    on a data path (run once each, on demand) → (results, JSON, lines)."""
    tmp = tmp_path_factory.mktemp("cli")
    paths = generate_dataset(str(tmp / "data"), n_train=3, n_test=3,
                             shape=(20, 48, 48), seed=0)
    _, variables = jax_rpnet(radius=2, num_iter=2, size=32, seed=3)
    ckpt = str(tmp / "shared.pth")
    torch.save({"epoch": 0, "state_dict": state_dict_from_jax(variables)}, ckpt)
    runs = {}

    def run(name, cli, extra, **kw):
        if name not in runs:
            out = str(tmp / name)
            ypath = str(tmp / f"{name}.yml")
            with open(ypath, "w") as f:
                yaml.safe_dump(_config(paths, out, ckpt, **kw), f)
            stdout = sys.stdout
            try:
                res = cli.main(["--yaml", ypath] + extra)
            finally:
                sys.stdout = stdout   # the JAX CLI leaves its log tee installed
            assert sys.stdout is stdout
            with open(f"{out}/results_eval.json") as f:
                runs[name] = (res, json.load(f), _episode_lines(f"{out}/log_eval"))
        return runs[name]

    def port(data_path):
        return run(f"torch_{data_path}", torch_cli, ["--platform", "cpu"],
                   **DATA_PATHS[data_path])

    def served():
        """The port's cli.export, then cli.serve on the artifact, the same
        YAML and ``.pth`` (the default data path)."""
        if "served" not in runs:
            out, ypath, art = str(tmp / "served"), str(tmp / "served.yml"), str(tmp / "art")
            with open(ypath, "w") as f:
                yaml.safe_dump(_config(paths, out, ckpt), f)
            # 16 slices hold every episode of this dataset (9-12)
            export_cli.main(["--yaml", ypath, "--out", art, "--slices", "16",
                             "--platform", "cpu"])
            stdout = sys.stdout
            try:
                res = serve_cli.main(["--artifact", art, "--yaml", ypath, "--platform", "cpu"])
            finally:
                sys.stdout = stdout
            assert sys.stdout is stdout
            with open(f"{out}/results_eval.json") as f:
                runs["served"] = (res, json.load(f), _episode_lines(f"{out}/log_serve"))
        return runs["served"]

    return run("jax", jax_cli, [], reg_sampler="gather"), port, served


@pytest.mark.parametrize("data_path", list(DATA_PATHS))
def test_cli_parity(cli_runs, data_path):
    (_, j, jl), port, _ = cli_runs
    _, t, tl = port(data_path)
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

    assert len(jl) == 6   # 3 episodes; the pass and aggregate class lines; ref line
    assert tl == jl
    if data_path == "defaults":   # the port's two data paths print the same lines
        assert tl == port("num_workers=0")[2]


def test_serve_cli_matches_jax(cli_runs):
    """The port's served eval (``cli.export`` then ``cli.serve``, f32, the
    default data path, volumes read through the native raw cache) against
    the JAX package's live eval CLI: every per-class affine, fewshot and
    per-iteration Dice within 1e-3, and the port's live CLI's per-episode
    lines."""
    (_, j, jl), port, served = cli_runs
    _, s, sl = served()
    assert s["episodes"] == j["episodes"] == 3
    assert s["failed_episodes"] == j["failed_episodes"] == 0
    jc, sc = j["classes"]["Liver"], s["classes"]["Liver"]
    assert set(sc["refinement"]) == set(jc["refinement"]) == {"0", "1"}
    for key in ("affine", "fewshot"):
        np.testing.assert_allclose(sc[key], jc[key], atol=1e-3, err_msg=key)
    for it in jc["refinement"]:
        np.testing.assert_allclose(sc["refinement"][it], jc["refinement"][it],
                                   atol=1e-3, err_msg=f"ref {it}")
    assert sl == port("defaults")[2] == jl


def test_deformable_eval_matches_jax(tmp_path, capsys, monkeypatch):
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
