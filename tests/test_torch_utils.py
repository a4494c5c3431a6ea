"""rpnet_tpu_torch/utils/profiling.py, core/metrics.py's host metrics and
utils/visualize.py against the JAX package's modules, and ``debug_nans``
through the port's eval CLI.

  * ``StageTimer``: the JAX timer's ``stage_timing`` line for the same
    stages; a stage fenced on tensors;
  * ``enable_nan_debugging``: a hook raises ``FloatingPointError`` naming
    the first module whose output holds a NaN; ``debug_nans: true`` makes
    the eval CLI raise at the first NaN of an episode whose query volume
    holds one and count that episode as failed, as the JAX CLI does
    (without it the same episode runs through), and runs clean episodes;
  * ``mse`` and ``precision_and_recall`` equal to the JAX ones;
  * ``visualize``: the arrays and PNGs it makes equal to the JAX module's
    (``cv2`` and ``matplotlib`` are imported lazily; the card's machine has
    neither).
"""

import os
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from rpnet_tpu.core import metrics as jax_metrics
from rpnet_tpu.utils import profiling as jax_profiling
from rpnet_tpu.utils import visualize as jax_visualize
from rpnet_tpu_torch.cli import test_rpnet as torch_eval_cli
from rpnet_tpu_torch.core import metrics
from rpnet_tpu_torch.core.synthetic import generate_dataset
from rpnet_tpu_torch.episode.sampler import EpisodeSampler
from rpnet_tpu_torch.utils import profiling, visualize

torch.set_num_threads(2)   # small shapes; the suite runs several workers on one machine


def test_stage_timer_report_matches_jax():
    ours, theirs = profiling.StageTimer(), jax_profiling.StageTimer()
    for t in (ours, theirs):
        for name, secs in (("dispatch", 0.25), ("data", 0.0015), ("dispatch", 0.5)):
            t.totals[name] += secs
            t.counts[name] += 1
    assert ours.report() == theirs.report() == "stage_timing dispatch=0.750s/2x data=0.002s/1x"
    assert ours.as_dict() == theirs.as_dict()

    timer = profiling.StageTimer()
    with timer.stage("episode", block_on={"out": [torch.ones(3) * 2]}):
        time.sleep(0.01)
    with timer.stage("episode"):
        pass
    assert timer.counts["episode"] == 2 and timer.totals["episode"] >= 0.01
    assert timer.report().startswith("stage_timing episode=")


def test_nan_hooks_name_the_first_module():
    class Bad(torch.nn.Module):
        def forward(self, x):
            return {"out": torch.log(x - 10)}

    model = torch.nn.Sequential(torch.nn.Linear(4, 4), torch.nn.ReLU(), Bad())
    assert not torch.is_anomaly_enabled()
    profiling.enable_nan_debugging(True, model)
    try:
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        with pytest.raises(FloatingPointError, match=r"NaN in the output of 2 \(Bad\)"):
            model(torch.ones(2, 4))
        x = torch.tensor([1.0, -1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="returned nan values"):
            torch.sqrt(x).sum().backward()
    finally:
        profiling.enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()
    model(torch.ones(2, 4))   # hooks removed


@pytest.fixture(scope="module")
def eval_data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("debug_nans")
    paths = generate_dataset(str(tmp / "data"), n_train=1, n_test=2,
                             shape=(16, 48, 48), seed=0)
    cfg = dict(data_dir=paths["data_dir"], class_csv_dir=paths["class_dir"],
               eval_set_name=paths["test_csv"], num_slice=16, num_x=48, num_y=48,
               crop_size=[32, 32], k=2, eval_classes=["Liver"], n_iter_refinement=1,
               n_test_iter_refinement=1, mask_refinement_correlation_radius=1,
               reg_affine_iters=3, n_runs=1, seed=0, use_native_io=False)
    return tmp, cfg


def _run_eval(tmp, cfg, name):
    path = str(tmp / f"{name}.yml")
    with open(path, "w") as f:
        yaml.safe_dump(dict(cfg, out_dir=str(tmp / name)), f)
    stdout = sys.stdout
    try:
        return torch_eval_cli.main(["--yaml", path, "--platform", "cpu"])
    finally:
        sys.stdout = stdout


@pytest.fixture
def nan_in_first_query(eval_data, monkeypatch):
    """Episode 0's query volume with one NaN voxel, wherever it is loaded."""
    from rpnet_tpu_torch.config import Config

    tmp, cfg = eval_data
    s = EpisodeSampler(cfg["data_dir"], cfg["eval_set_name"], Config(cfg))
    ci, di = s.indices[0]
    target = s.data_info[ci][di]["pid"]
    load = EpisodeSampler.load_image_and_mask

    def poisoned(sampler, pid, roi):
        img, mask = load(sampler, pid, roi)
        if pid == target:
            img = img.copy()
            img[img.shape[0] // 2, 5, 5] = np.nan
        return img, mask

    monkeypatch.setattr(EpisodeSampler, "load_image_and_mask", poisoned)


def test_debug_nans_passes_clean_episodes(eval_data):
    tmp, cfg = eval_data
    results = _run_eval(tmp, dict(cfg, debug_nans=True), "clean")
    assert results["failed_episodes"] == 0 and results["episodes"] == 2
    assert not torch.is_anomaly_enabled()     # the CLI turns it off again


@pytest.mark.usefixtures("nan_in_first_query")
def test_debug_nans_raises_on_a_nan_episode(eval_data):
    """The switch off, the NaN runs through; on, episode 0 raises at its
    first NaN, which the CLI logs and counts as a failed episode and goes
    on, as the JAX CLI counts ``jax_debug_nans``'s error. The first NaN is
    in the registration fit's gradient (anomaly detection's error; the JAX
    CLI's is in the fit's scan), before any module's forward hook."""
    tmp, cfg = eval_data
    results = _run_eval(tmp, cfg, "nan_unchecked")
    assert results["failed_episodes"] == 0
    results = _run_eval(tmp, dict(cfg, debug_nans=True), "nan_checked")
    assert results["failed_episodes"] == 1 and results["episodes"] == 2
    with open(tmp / "nan_checked" / "log_eval") as f:
        log = f.read()
    assert "0 EPISODE FAILED" in log and "returned nan values" in log
    assert "1 EPISODE FAILED" not in log
    assert not torch.is_anomaly_enabled()


def test_host_metrics_match_jax(rng):
    a = rng.randn(4, 9, 7).astype(np.float32)
    b = rng.randn(4, 9, 7).astype(np.float32)
    assert float(metrics.mse(torch.from_numpy(a), torch.from_numpy(b))) == pytest.approx(
        float(jax_metrics.mse(jnp.asarray(a), jnp.asarray(b))), rel=1e-6)
    gt = rng.randint(0, 4, (6, 10, 10))
    pred = np.where(rng.rand(6, 10, 10) < 0.7, gt, rng.randint(0, 4, (6, 10, 10)))
    pred[pred == 3] = 0       # a class never predicted: precision 0 / max(0, 1)
    for got, want in zip(metrics.precision_and_recall(gt, pred, 5),
                         jax_metrics.precision_and_recall(gt, pred, 5)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def test_visualize_arrays_match_jax(tmp_path, rng):
    img = rng.randn(5, 32, 32).astype(np.float32) * 200
    gt = np.zeros((5, 32, 32), np.uint8)
    gt[1:4, 8:20, 10:22] = 1
    pred = np.roll(gt, 2, axis=2)
    masks = {"gt": gt[2], "pred": pred[2]}
    for ours, theirs in (
            (visualize.draw_contours(img[2], masks), jax_visualize.draw_contours(img[2], masks)),
            (visualize.draw_bboxes(img[2], [[8, 10, 20, 22]]),
             jax_visualize.draw_bboxes(img[2], [[8, 10, 20, 22]])),
            (visualize.volume_grid(img, n_cols=3), jax_visualize.volume_grid(img, n_cols=3)),
            (visualize.normalize_for_display(img), jax_visualize.normalize_for_display(img)),
            (visualize.hu_window(img, 40, 400), jax_visualize.hu_window(img, 40, 400)),
            (visualize.label_overlay_rgba(gt[2] + pred[2], 0.7),
             jax_visualize.label_overlay_rgba(gt[2] + pred[2], 0.7))):
        np.testing.assert_array_equal(ours, theirs)
        assert ours.dtype == theirs.dtype

    def canvas(module):
        fig = module.render_slice(img, [gt, pred], z=2, level=40, width=400,
                                  class_names=["organ"])
        fig.canvas.draw()
        rgba = np.asarray(fig.canvas.buffer_rgba()).copy()
        import matplotlib.pyplot as plt
        plt.close(fig)
        return rgba

    np.testing.assert_array_equal(canvas(visualize), canvas(jax_visualize))
    ours = visualize.generate_image_pngs(img, {"gt": gt}, str(tmp_path / "ours"))
    theirs = jax_visualize.generate_image_pngs(img, {"gt": gt}, str(tmp_path / "theirs"))
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in theirs]
    for p, q in zip(ours, theirs):
        with open(p, "rb") as f, open(q, "rb") as g:
            assert f.read() == g.read()
