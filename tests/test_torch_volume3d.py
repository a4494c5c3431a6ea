"""rpnet_tpu_torch's whole-volume eval (``eval_3d``) vs the JAX package's.

Both packages run on one synthetic dataset (3 Liver volumes of 20×48×48,
32² crops, U-Net d4, r=2, 2 refinement iterations, 8 affine steps, the JAX
package's torch-exact ``reg_sampler: gather``, f32) with the same weights,
in windows of ``slice_bucket`` 8 slices overlapping by min(``overlap_3d``
8, 8 // 2) = 4:

  * the support matching and the window starts, with the tail clamp;
  * ``Volume3DRunner`` on one volume: the overlap-averaged prediction and
    prior agree with the JAX runner's on more than 99.9% of pixels, and
    their Dice within 1e-3; the port's device-cache (``EpisodeSpec``) and
    host windows give the same arrays;
  * the eval CLIs' ``evaluate_3d``: the JAX CLI's function on a JAX runner
    (built directly: the JAX CLI's ``main`` spends ~25 s initializing a model
    on the host) against the port's CLI ``main`` with ``eval_3d: True`` —
    the same supports from one seed, the same per-volume log lines (numbers
    aside) and per-volume Dice within 1e-3.
"""

import json
import random
import re

import numpy as np
import pytest
import torch
import yaml

from rpnet_tpu.cli import test_rpnet as jax_cli
from rpnet_tpu.config import Config as JaxConfig
from rpnet_tpu.core.synthetic import generate_dataset
from rpnet_tpu.episode.pipeline import EpisodeRunner as JaxEpisodeRunner
from rpnet_tpu.episode.sampler import EpisodeSampler as JaxEpisodeSampler
from rpnet_tpu.episode.volume3d import Volume3DRunner as JaxVolume3DRunner
from rpnet_tpu.episode.volume3d import match_support_slices as jax_match_support_slices
from rpnet_tpu_torch.cli import test_rpnet as torch_cli
from rpnet_tpu_torch.config import Config
from rpnet_tpu_torch.episode.sampler import EpisodeSampler
from rpnet_tpu_torch.episode.volume3d import (Volume3DRunner, match_support_slices,
                                              window_starts)
from rpnet_tpu_torch.train.convert import state_dict_from_jax

from test_torch_cli import _config
from test_torch_models import jax_rpnet

torch.set_num_threads(2)   # small shapes; the suite runs several workers on one machine

_FLOAT = re.compile(r"-?\d+\.\d+(e-?\d+)?")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(root, raw config, the JAX runner, the JAX config) on one dataset."""
    root = tmp_path_factory.mktemp("volume3d")
    paths = generate_dataset(str(root / "data"), n_train=1, n_test=3,
                             shape=(20, 48, 48), classes=("Liver",), seed=0)
    model, variables = jax_rpnet(radius=2, num_iter=2, size=32, seed=3)
    ckpt = str(root / "shared.pth")
    torch.save({"epoch": 0, "state_dict": state_dict_from_jax(variables)}, ckpt)
    raw = _config(paths, str(root / "out"), ckpt, eval_3d=True, overlap_3d=8,
                  reg_sampler="gather")
    jconfig = JaxConfig(raw).replace(n_iter_refinement=raw["n_test_iter_refinement"])
    return root, raw, JaxEpisodeRunner(model, variables, jconfig), jconfig


def test_support_matching_and_windows():
    for ns, nq in ((40, 17), (7, 30), (12, 12), (5, 1)):
        np.testing.assert_array_equal(match_support_slices(ns, nq),
                                      jax_match_support_slices(ns, nq))
    assert window_starts(48, 32, 8) == [0, 16]            # the tail clamped to 48 - 32
    assert window_starts(100, 32, 8) == [0, 24, 48, 68]
    assert window_starts(20, 8, 4) == [0, 4, 8, 12]
    assert window_starts(20, 32, 8) == [0]                 # one window past the end
    assert window_starts(1, 8, 4) == [0]


def test_volume_runner_matches_jax(setup):
    _, raw, jrunner, _ = setup
    config = Config(raw).replace(n_iter_refinement=raw["n_test_iter_refinement"])
    runner = torch_cli.build_runner(config, torch.device("cpu"))
    sampler = EpisodeSampler(raw["data_dir"], raw["eval_set_name"], config)
    roi = config["eval_classes"][0]
    keys = [(sampler.data_info[0][i]["pid"], roi) for i in (1, 0)]
    supp, qry = (sampler.load_image_and_mask(*k) for k in keys)

    ref = JaxVolume3DRunner(jrunner, overlap=8).run_volume(*supp, *qry)
    vrunner = Volume3DRunner(runner, window=8, overlap=8)
    host = vrunner.run_volume(*supp, *qry)
    spec = vrunner.run_volume(*supp, *qry, sampler=sampler, supp_key=keys[0],
                              qry_key=keys[1])
    assert qry[0].shape[0] > 8 and host.n_windows == ref.n_windows == 2
    np.testing.assert_array_equal(host.prediction, spec.prediction)
    np.testing.assert_array_equal(host.appr_label, spec.appr_label)
    assert host.prediction.shape == ref.prediction.shape == qry[0].shape
    assert np.mean(host.prediction == ref.prediction) > 0.999
    assert np.mean(host.appr_label == ref.appr_label) > 0.999
    assert host.prediction.sum() > 0 and host.appr_label.sum() > 0
    assert abs(host.dsc_fewshot - ref.dsc_fewshot) < 1e-3
    assert abs(host.dsc_affine - ref.dsc_affine) < 1e-3


def _volume_lines(text):
    return [_FLOAT.sub("#", l.rstrip()) for l in text.splitlines()
            if re.match(r"^\d+ syn\d+ syn\d+ affine ", l) or l.startswith("Liver, affine")]


def test_eval_3d_cli_matches_jax(setup, capsys):
    root, raw, jrunner, jconfig = setup
    random.seed(int(jconfig.get("seed", 0)))      # as the JAX CLI's main seeds it
    jsampler = JaxEpisodeSampler(raw["data_dir"], raw["eval_set_name"], jconfig, mode="eval")
    j_aff, j_few, _, j_fail = jax_cli.evaluate_3d(jrunner, jsampler, jconfig)
    jl = _volume_lines(capsys.readouterr().out)

    ypath = str(root / "torch.yml")
    with open(ypath, "w") as f:
        yaml.safe_dump(raw, f)
    res = torch_cli.main(["--yaml", ypath, "--platform", "cpu"])
    with open(str(root / "out" / "log_eval")) as f:
        tl = _volume_lines(f.read())
    with open(str(root / "out" / "results_eval.json")) as f:
        assert json.load(f)["classes"] == json.loads(json.dumps(res["classes"]))

    assert j_fail == 0 and res["failed_episodes"] == 0 and res["episodes"] == 3
    assert len(jl) == 4 and tl[:4] == jl   # 3 volumes and the class line of the pass
    # per volume, from the lines' numbers
    nums = lambda lines: np.array([[float(m.group()) for m in _FLOAT.finditer(l)]
                                   for l in lines[:3]])
    with open(str(root / "out" / "log_eval")) as f:
        t_lines = [l for l in f if re.match(r"^\d+ syn\d+ syn\d+ affine ", l)]
    np.testing.assert_allclose(nums(t_lines), np.array([j_aff["Liver"], j_few["Liver"]]).T,
                               atol=1e-3)
    for key, ref in (("affine", j_aff), ("fewshot", j_few)):
        np.testing.assert_allclose(res["classes"]["Liver"][key][0], np.mean(ref["Liver"]),
                                   atol=1e-3, err_msg=key)
