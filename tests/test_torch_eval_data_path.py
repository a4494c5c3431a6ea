"""The eval data path of rpnet_tpu_torch: index-only episodes from a device
volume cache, prefetch threads, the plain host path, and the pipelined loop.

On a small synthetic split (3 Liver volumes, 64² crops, at most 2 query
slices an episode, 2 refinement iterations, 3 affine steps, f32 on the CPU):
  * the port's ``sample_spec`` rows equal the JAX package's on the same
    split and picks, and gather the episode ``sample`` assembles;
  * per episode the packed metrics are bit-equal on the spec path (cache 16
    and an evicting cache of 1), on the prefetch path (cache 0,
    ``num_workers: 2``) and on the plain path, and each path consumes the
    same stdlib ``random`` draws;
  * a volume that cannot be read costs exactly the episodes that use it, on
    each path, and the loop prints its lines in index order;
  * prefetch threads sharing the sampler's volume LRU (one entry, evicting on
    every load) under a short switch interval give the serial episodes.
"""

import os
import random
import re
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from rpnet_tpu.config import Config as JaxConfig
from rpnet_tpu.episode.sampler import EpisodeSampler as JaxEpisodeSampler
from rpnet_tpu_torch.cli.test_rpnet import evaluate
from rpnet_tpu_torch.config import Config
from rpnet_tpu_torch.core.synthetic import generate_dataset
from rpnet_tpu_torch.episode.pipeline import EpisodeRunner
from rpnet_tpu_torch.episode.prefetch import EpisodeFailure, PrefetchingSampler
from rpnet_tpu_torch.episode.sampler import EpisodeSampler
from rpnet_tpu_torch.models.factory import build_rpnet

torch.set_num_threads(2)   # small shapes; the suite runs several workers on one machine

PATHS = {"spec": dict(device_volume_cache=16, num_workers=0),
         "spec_lru1": dict(device_volume_cache=1, num_workers=0),
         "prefetch": dict(device_volume_cache=0, num_workers=2),
         "plain": dict(device_volume_cache=0, num_workers=0)}


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return generate_dataset(str(tmp_path_factory.mktemp("dp") / "data"), n_train=1,
                            n_test=3, shape=(12, 72, 72), classes=("Liver",), seed=4)


def _raw(paths, **kw):
    cfg = dict(data_dir=paths["data_dir"], class_csv_dir=paths["class_dir"],
               eval_set_name=paths["test_csv"], train_set_name=paths["train_csv"],
               num_slice=16, num_x=72, num_y=72, crop_size=[64, 64], k=4, n_shot=2,
               eval_classes=["Liver"], train_classes=["Liver"],
               n_iter_refinement=2, mask_refinement_correlation_radius=2,
               reg_affine_iters=3, max_slices=2, compute_dtype="float32")
    cfg.update(kw)
    return cfg


@pytest.fixture(scope="module")
def model(paths):
    return build_rpnet(Config(_raw(paths)), num_iter=2, seed=0)


@pytest.mark.parametrize("test_shot", [1, 3])
def test_sample_spec_matches_jax_and_sample(paths, test_shot):
    raw = _raw(paths, test_shot=test_shot, k=3)
    ours = EpisodeSampler(paths["data_dir"], paths["test_csv"], Config(raw))
    ref = JaxEpisodeSampler(paths["data_dir"], paths["test_csv"], JaxConfig(raw),
                            mode="eval")
    random.seed(5)
    picks = [ours.draw_supports(j) for j in range(len(ours))]
    state = random.getstate()
    for j in range(len(ours)):
        spec = ours.sample_spec(j, picks=picks[j])
        jspec = ref.sample_spec(j, picks=picks[j])
        np.testing.assert_array_equal(spec.supp_rows, jspec.supp_rows)
        assert spec.supp_rows.dtype == np.int32
        assert (spec.supp_key, spec.qry_key, spec.n_slices, spec.class_id, spec.pid,
                spec.supp_pids) == (jspec.supp_key, jspec.qry_key, jspec.n_slices,
                                    jspec.class_id, jspec.pid, jspec.supp_pids)
        ep = ours.sample(j, picks=picks[j])
        s_img, s_lab = ours.load_image_and_mask(*spec.supp_key)
        q_img, _ = ours.load_image_and_mask(*spec.qry_key)
        np.testing.assert_array_equal(ep.support_images, s_img[spec.supp_rows])
        np.testing.assert_array_equal(ep.support_labels, s_lab[spec.supp_rows])
        np.testing.assert_array_equal(ep.query_images, q_img)
    assert random.getstate() == state   # neither path draws from the stream


@pytest.mark.parametrize("kw", [dict(use_all_supports=True), dict(multishot_fusion=True)],
                         ids=["use_all_supports", "multishot_fusion"])
def test_sample_spec_declines_host_assembled_episodes(paths, kw):
    raw = _raw(paths, **kw)
    ours = EpisodeSampler(paths["data_dir"], paths["test_csv"], Config(raw))
    ref = JaxEpisodeSampler(paths["data_dir"], paths["test_csv"], JaxConfig(raw),
                            mode="eval")
    assert ours.sample_spec(0, picks=[1, 2]) is None
    assert ref.sample_spec(0, picks=[1, 2]) is None
    train = EpisodeSampler(paths["data_dir"], paths["test_csv"], Config(_raw(paths)),
                           mode="train")
    assert train.sample_spec(0, picks=[1]) is None


def _run_pass(paths, model, capsys, **kw):
    """One eval pass on ``kw``'s data path: each episode's finalized metrics,
    the printed episode indices in order, the failure count and the stdlib
    random state after the pass."""
    config = Config(_raw(paths, **kw))
    runner = EpisodeRunner(model, config, "cpu")
    results = []
    finalize = runner.finalize
    runner.finalize = lambda d: results.append(finalize(d)) or results[-1]
    sampler = EpisodeSampler(config["data_dir"], config["eval_set_name"], config)
    random.seed(0)
    capsys.readouterr()
    *_, failures = evaluate(runner, sampler, config)
    out = capsys.readouterr().out
    printed = [int(m.group(1)) for m in
               re.finditer(r"^(\d+) (?:syn\d+ syn\d+ affine|EPISODE FAILED)", out, re.M)]
    return results, printed, failures, random.getstate(), runner, out


def test_data_paths_bit_equal(paths, model, capsys):
    runs = {name: _run_pass(paths, model, capsys, **kw) for name, kw in PATHS.items()}
    ref, printed, failures, state, runner, out = runs["plain"]
    assert len(ref) == 3 and failures == 0 and printed == [0, 1, 2]
    assert all(r["dsc_affine"] is not None for r in ref)
    assert re.search(r"stage_timing .*data=.*dispatch=.*", out) or \
        re.search(r"stage_timing .*dispatch=.*data=.*", out)
    for name, (res, pr, fl, st, rn, _) in runs.items():
        assert res == ref, name          # every float bit for bit
        assert (pr, fl, st) == (printed, failures, state), name
    assert len(runs["spec"][4]._dev_vols) == 3
    assert len(runs["spec_lru1"][4]._dev_vols) == 1    # evicted, same results
    assert not runs["plain"][4]._dev_vols


@pytest.mark.parametrize("name", ["spec", "prefetch", "plain"])
def test_unreadable_volume_costs_its_episodes(paths, model, capsys, tmp_path, name):
    bad_dir = tmp_path / "data"
    bad_dir.mkdir()
    for f in os.listdir(paths["data_dir"]):
        os.symlink(os.path.join(paths["data_dir"], f), bad_dir / f)
    # one support: the spec path loads the last pick only, the host paths
    # every pick (as the JAX package's do)
    ours = EpisodeSampler(paths["data_dir"], paths["test_csv"], Config(_raw(paths, n_shot=1)))
    bad = ours.data_info[0][1]["pid"]
    os.unlink(bad_dir / f"{bad}_clean.nrrd")
    (bad_dir / f"{bad}_clean.nrrd").write_bytes(b"NRRD0004\nnot a volume\n")
    random.seed(0)
    picks = [ours.draw_supports(j) for j in range(len(ours))]
    expect = sum(j == 1 or 1 in p for j, p in enumerate(picks))
    assert 0 < expect < 3
    bad_paths = dict(paths, data_dir=str(bad_dir))
    res, printed, failures, _, _, _ = _run_pass(bad_paths, model, capsys, n_shot=1,
                                                **PATHS[name])
    assert failures == expect and len(res) == 3 - expect
    assert printed == [0, 1, 2]   # failed or not, every episode in index order


def test_prefetch_threads_share_the_volume_cache(paths):
    config = Config(_raw(paths, volume_cache=1))
    sampler = EpisodeSampler(config["data_dir"], config["eval_set_name"], config)
    random.seed(2)
    picks = {j: sampler.draw_supports(j) for j in range(len(sampler))}
    serial = {j: sampler.sample(j, picks=picks[j]) for j in picks}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:   # eight passes over the split at once: 24 episodes in flight
        with ThreadPoolExecutor(8) as pool:
            passes = list(pool.map(lambda _: list(PrefetchingSampler(
                sampler, lookahead=3, workers=3, picks=picks)), range(8)))
    finally:
        sys.setswitchinterval(interval)
    got = [ep for p in passes for ep in p]
    indices = list(picks) * 8
    assert len(got) == len(indices)
    for j, ep in zip(indices, got):
        assert not isinstance(ep, EpisodeFailure), ep.exc
        np.testing.assert_array_equal(ep.support_images, serial[j].support_images)
        np.testing.assert_array_equal(ep.query_labels, serial[j].query_labels)
    assert len(sampler._vol_cache) == 1
