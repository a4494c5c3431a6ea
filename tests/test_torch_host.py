"""rpnet_tpu_torch's copies of the JAX package's host modules hold to their
originals: the synthetic dataset, the NRRD codec, the YAML defaults, the
eval and train samplers and the train-time augmentations give identical
values from the same inputs and seed."""

import os
import random

import numpy as np
import pytest

from rpnet_tpu import config as jax_config
from rpnet_tpu.core import nrrd_io as jax_nrrd
from rpnet_tpu.core import synthetic as jax_synthetic
from rpnet_tpu.core.synthetic import generate_dataset as jax_generate_dataset
from rpnet_tpu.episode.sampler import EpisodeSampler as JaxEpisodeSampler
from rpnet_tpu.episode.sampler import random_affine_2d as jax_random_affine_2d
from rpnet_tpu.episode.sampler import slice_bins as jax_slice_bins
from rpnet_tpu_torch import config
from rpnet_tpu_torch.core import nrrd_io
from rpnet_tpu_torch.core import synthetic
from rpnet_tpu_torch.core.synthetic import generate_dataset
from rpnet_tpu_torch.core.transforms import gamma_transform
from rpnet_tpu_torch.episode.sampler import (EpisodeSampler, random_affine_2d,
                                             slice_bins, warp_affine_nearest)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("host")
    kw = dict(n_train=1, n_test=4, shape=(18, 44, 44), classes=("Liver", "Spleen"),
              seed=2)
    return (jax_generate_dataset(str(root / "jax"), **kw),
            generate_dataset(str(root / "torch"), **kw))


def test_synthetic_dataset_matches_jax(datasets):
    jp, tp = datasets
    names = sorted(os.listdir(jp["data_dir"]))
    assert names == sorted(os.listdir(tp["data_dir"])) and len(names) == 15
    for name in names:
        a, _ = jax_nrrd.read(os.path.join(jp["data_dir"], name))
        b, _ = jax_nrrd.read(os.path.join(tp["data_dir"], name))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=name)
    for key in ("train_csv", "test_csv"):
        with open(jp[key]) as f, open(tp[key]) as g:
            assert f.read() == g.read()
    for roi in ("Liver", "Spleen"):
        with open(os.path.join(jp["class_dir"], f"{roi}.csv")) as f, \
                open(os.path.join(tp["class_dir"], f"{roi}.csv")) as g:
            assert f.read().replace(jp["data_dir"], "") == \
                g.read().replace(tp["data_dir"], "")


@pytest.mark.parametrize("dtype,encoding", [("int16", "gzip"), ("uint8", "raw"),
                                            ("float32", "gzip")])
def test_nrrd_codec_interchanges_with_jax(tmp_path, dtype, encoding):
    a = (np.random.RandomState(0).randn(5, 7, 3) * 100).astype(dtype)
    nrrd_io.write(str(tmp_path / "t.nrrd"), a, encoding=encoding)
    jax_nrrd.write(str(tmp_path / "j.nrrd"), a, encoding=encoding)
    np.testing.assert_array_equal(jax_nrrd.read(str(tmp_path / "t.nrrd"))[0], a)
    np.testing.assert_array_equal(nrrd_io.read(str(tmp_path / "j.nrrd"))[0], a)


def test_config_reads_the_example_yaml_as_jax_does():
    path = os.path.join(ROOT, "yamls", "example.yml")
    raw = config.load_yaml(path)
    jax_raw, _ = jax_config.load_yaml(path)
    assert raw == jax_raw
    for cfg, jcfg in ((config.Config(raw), jax_config.Config(jax_raw)),
                      (config.Config({}), jax_config.Config({}))):
        for key in config._DEFAULTS:
            assert cfg[key] == jcfg[key], key
    assert config.Config({"n_shot": 3})["test_shot"] == 3
    # the native IO keys: on in the example, the cache beside the NRRDs
    assert {"use_native_io", "io_cache_dir"} <= set(config._DEFAULTS)
    assert config.Config(raw)["use_native_io"] is True and raw["use_native_io"] is True
    assert config.Config({})["io_cache_dir"] is None


@pytest.mark.parametrize("sizes,nq,k", [([30], 17, 12), ([5], 40, 12), ([9, 13], 11, 4)])
def test_slice_bins_match_jax(sizes, nq, k):
    out, ref = slice_bins(sizes, nq, k), jax_slice_bins(sizes, nq, k)
    assert out[0] == ref[0]
    for a, b in zip(out[1], ref[1]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(out[2], ref[2])


@pytest.mark.parametrize("test_shot", [1, 2])
def test_eval_sampler_matches_jax(datasets, test_shot):
    """Same supports from the same stdlib seed, identical episode arrays."""
    jp, tp = datasets
    raw = dict(class_csv_dir=tp["class_dir"], eval_classes=["Liver", "Spleen"],
               num_slice=32, num_x=48, num_y=48, crop_size=[32, 32], k=4,
               test_shot=test_shot, use_native_io=False)
    ours = EpisodeSampler(tp["data_dir"], tp["test_csv"], config.Config(raw))
    ref = JaxEpisodeSampler(tp["data_dir"], tp["test_csv"],
                            jax_config.Config(raw), mode="eval")
    assert len(ours) == len(ref) == 8
    random.seed(5)
    picks = [ours.draw_supports(j) for j in range(len(ours))]
    random.seed(5)
    assert picks == [ref.draw_supports(j) for j in range(len(ref))]
    for j, p in enumerate(picks):
        a, b = ours.sample(j, picks=p), ref.sample(j, picks=p)
        assert (a.class_id, a.pid, a.supp_pids) == (b.class_id, b.pid, b.supp_pids)
        for name in ("support_images", "support_labels", "query_images",
                     "query_labels"):
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(x, y, err_msg=f"{j} {name}")


def test_train_sampler_matches_jax(datasets):
    """Train mode from one stdlib + numpy seed: the same supports, query
    slices, gamma jitter, random affines and shuffles — identical arrays."""
    _, tp = datasets
    raw = dict(class_csv_dir=tp["class_dir"], train_classes=["Liver", "Spleen"],
               num_slice=32, num_x=48, num_y=48, crop_size=[32, 32], k=4,
               do_intaug=True, use_native_io=False)
    ours = EpisodeSampler(tp["data_dir"], tp["test_csv"], config.Config(raw), mode="train")
    ref = JaxEpisodeSampler(tp["data_dir"], tp["test_csv"], jax_config.Config(raw),
                            mode="train")
    assert len(ours) == len(ref) == 8
    episodes = {}
    for name, sampler in (("ours", ours), ("ref", ref)):
        random.seed(3)
        np.random.seed(3)
        episodes[name] = [sampler.sample(j) for j in range(len(sampler))]
    for j, (a, b) in enumerate(zip(episodes["ours"], episodes["ref"])):
        assert (a.class_id, a.pid, a.supp_pids) == (b.class_id, b.pid, b.supp_pids)
        for name in ("support_images", "support_labels", "query_images",
                     "query_labels"):
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype == np.float32 and x.shape[-3] == 4
            np.testing.assert_array_equal(x, y, err_msg=f"{j} {name}")


def test_warp_affine_nearest_matches_cv2():
    """The numpy warp against cv2.warpAffine(INTER_NEAREST) over 400 random
    affines of the train augmentation's range, square and ragged shapes:
    no pixel differs."""
    import cv2

    rng = np.random.RandomState(0)
    for t in range(400):
        H, W = [(256, 256), (37, 53), (64, 64), (20, 300)][t % 4]
        img = rng.rand(H, W).astype(np.float32)
        M = cv2.getRotationMatrix2D((W / 2, H / 2), rng.uniform(-5, 5), rng.uniform(0.7, 1.5))
        M[0, 2] += rng.uniform(-0.2, 0.2) * W
        M[1, 2] += rng.uniform(-0.2, 0.2) * H
        ref = cv2.warpAffine(img, M, (W, H), flags=cv2.INTER_NEAREST, borderValue=0.0)
        np.testing.assert_array_equal(warp_affine_nearest(img, M), ref, err_msg=str(t))


def test_train_augmentations_match_jax():
    """random_affine_2d and gamma_transform draw the same numbers from the
    global numpy stream and give the same images as the JAX package's."""
    from rpnet_tpu.core.transforms import gamma_transform as jax_gamma

    rng = np.random.RandomState(1)
    img = np.clip(rng.randn(48, 40) * 0.5, -1, 1).astype(np.float32)
    lab = (rng.rand(48, 40) > 0.7).astype(np.float32)
    outs = []
    for affine, gamma in ((random_affine_2d, gamma_transform),
                          (jax_random_affine_2d, jax_gamma)):
        np.random.seed(4)
        outs.append([gamma(img, [0.5, 1.5]), *affine(img, lab), np.random.rand()])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_host_dice_matches_jax():
    """``dice_score`` (per label value) and ``dice_score_seperate`` (per
    channel): the same rounded values, None where a class has no ground
    truth."""
    from rpnet_tpu.core.metrics import dice_score as jax_dice_score
    from rpnet_tpu.core.metrics import dice_score_seperate as jax_dice_score_seperate
    from rpnet_tpu_torch.core.metrics import dice_score, dice_score_seperate

    rng = np.random.RandomState(4)
    pred = rng.randint(0, 3, (6, 9, 9))
    true = rng.randint(0, 2, (6, 9, 9))          # no voxel of class 2
    out = dice_score(pred, true, num_class=3)
    assert out == jax_dice_score(pred, true, num_class=3) and out[2] is None
    chans_p = (rng.rand(3, 5, 8, 8) > 0.5).astype(np.float32)
    chans_t = (rng.rand(3, 5, 8, 8) > 0.6).astype(np.float32)
    chans_t[1] = 0
    out = dice_score_seperate(chans_p, chans_t, num_class=3, decimal=3)
    assert out == jax_dice_score_seperate(chans_p, chans_t, num_class=3, decimal=3)
    assert out[1] is None and out[0] is not None


def test_lgca_defaults_match_jax():
    """The LGCANet_V3 keys: ``context_net_downsample_scale`` from the JAX
    Config, and ``lgca_slices``, ``net_UNet`` and ``feature_scale``, which
    the JAX package defaults in its code, as its sampler and factory read
    them from a config without them."""
    from rpnet_tpu.models.factory import build_lgcanet as jax_build_lgcanet
    from rpnet_tpu_torch.models.factory import build_lgcanet

    cfg, jcfg = config.Config({}), jax_config.Config({})
    assert cfg["context_net_downsample_scale"] == jcfg["context_net_downsample_scale"]
    assert cfg["lgca_slices"] == 8          # rpnet_tpu/episode/lgca_data.py:60
    raw = {"roi_names": ["Liver", "Spleen", "Kidney L"]}
    jmodel = jax_build_lgcanet(jax_config.Config(raw))
    model = build_lgcanet(raw)
    assert (model.output_ch, model.unet.attention_gates) == (jmodel.output_ch, False)
    assert cfg["feature_scale"] == jmodel.feature_scale and cfg["net_UNet"] == "U_Net"
    assert model.unet.Conv1.conv[0].out_channels == 64
    gated = build_lgcanet(dict(raw, net_UNet="AttU_Net", feature_scale=8))
    assert gated.unet.attention_gates and gated.unet.Conv1.conv[0].out_channels == 8
    assert jax_build_lgcanet(jax_config.Config(dict(raw, net_UNet="AttU_Net"))).attention_gates


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_lgca_sampler_matches_jax(datasets, mode):
    """``LGCAVolumeSampler``: the same working shape, volume, masks and
    slices, array for array, and in train mode the same ``slice_idx`` from
    the same ``RandomState`` stream, on 44² volumes of 18 slices padded and
    cropped to a 32 × 48 × 32 working shape; a missing ROI file gives an
    empty mask channel in both."""
    from rpnet_tpu.episode.lgca_data import LGCAVolumeSampler as JaxLGCAVolumeSampler
    from rpnet_tpu_torch.episode.lgca_data import LGCAVolumeSampler

    _, tp = datasets
    raw = dict(roi_names=["Liver", "Spleen", "Kidney L"], num_slice=20, num_x=30, num_y=40,
               lgca_slices=5, context_net_downsample_scale=[2, 2, 1])
    ours = LGCAVolumeSampler(tp["data_dir"], tp["test_csv"], config.Config(raw), mode=mode)
    ref = JaxLGCAVolumeSampler(tp["data_dir"], tp["test_csv"], jax_config.Config(raw),
                               mode=mode)
    assert len(ours) == len(ref) == 4 and ours.shape == ref.shape == (32, 64, 32)
    rng_a, rng_b = np.random.RandomState(6), np.random.RandomState(6)
    for rep in range(2):                  # the second pass reads the volume cache
        for j in range(len(ours)):
            a, b = ours.sample(j, rng=rng_a), ref.sample(j, rng=rng_b)
            assert a["pid"] == b["pid"]
            for k in ("volume", "downsampled_volume_mask", "slices", "mask", "slice_idx"):
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{rep} {j} {k}")
            assert not a["mask"][..., 2].any()            # no Kidney L in this set
            assert a["slices"].shape[0] == (5 if mode == "train" else 32)
    assert not ours._vol_cache[ours.filenames[0]][0].flags.writeable


def test_multiclass_proxy_matches_jax(tmp_path):
    """The 11-class Abd-110 proxy: the same volume and masks for a seed, and
    the same files for a dataset of every class."""
    assert synthetic.ABD110_CLASSES == jax_synthetic.ABD110_CLASSES
    assert synthetic.PROXY_TRAIN_CLASSES == jax_synthetic.PROXY_TRAIN_CLASSES
    assert synthetic.PROXY_EVAL_CLASSES == jax_synthetic.PROXY_EVAL_CLASSES
    vol, masks = synthetic.make_patient_multiclass((14, 40, 44), 7)
    jvol, jmasks = jax_synthetic.make_patient_multiclass((14, 40, 44), 7)
    assert vol.dtype == jvol.dtype and list(masks) == list(jmasks)
    np.testing.assert_array_equal(vol, jvol)
    for roi in masks:
        np.testing.assert_array_equal(masks[roi], jmasks[roi], err_msg=roi)
    kw = dict(n_train=1, n_test=1, shape=(12, 36, 36),
              classes=synthetic.ABD110_CLASSES, seed=1)
    jp = jax_generate_dataset(str(tmp_path / "jax"), **kw)
    tp = generate_dataset(str(tmp_path / "torch"), **kw)
    names = sorted(os.listdir(jp["data_dir"]))
    assert names == sorted(os.listdir(tp["data_dir"])) and len(names) == 2 * 12
    for name in names:
        np.testing.assert_array_equal(nrrd_io.read(os.path.join(tp["data_dir"], name))[0],
                                      jax_nrrd.read(os.path.join(jp["data_dir"], name))[0],
                                      err_msg=name)
    for roi in synthetic.ABD110_CLASSES:
        with open(os.path.join(jp["class_dir"], f"{roi}.csv")) as f, \
                open(os.path.join(tp["class_dir"], f"{roi}.csv")) as g:
            assert f.read().replace(jp["data_dir"], "") == g.read().replace(tp["data_dir"], "")


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_npy_split_sampler_matches_jax(datasets, tmp_path, mode):
    """A ``.npy`` split: both samplers, each reading through its package's
    native raw cache (``use_native_io``, the default), draw the same
    episodes from one seed."""
    _, tp = datasets
    split = str(tmp_path / "split.npy")
    with open(tp["test_csv"]) as f:
        np.save(split, np.array([l.strip() for l in f if l.strip()]))
    classes = ["Liver", "Spleen"]
    raw = dict(class_csv_dir=tp["class_dir"], eval_classes=classes, train_classes=classes,
               num_slice=32, num_x=48, num_y=48, crop_size=[32, 32], k=4)
    ours = EpisodeSampler(tp["data_dir"], split,
                          config.Config(dict(raw, io_cache_dir=str(tmp_path / "t"))), mode=mode)
    ref = JaxEpisodeSampler(tp["data_dir"], split,
                            jax_config.Config(dict(raw, io_cache_dir=str(tmp_path / "j"))),
                            mode=mode)
    assert len(ours) == len(ref) == 8
    episodes = {}
    for name, sampler in (("ours", ours), ("ref", ref)):
        random.seed(4)
        np.random.seed(4)
        episodes[name] = [sampler.sample(j) for j in range(len(sampler))]
    for j, (a, b) in enumerate(zip(episodes["ours"], episodes["ref"])):
        assert (a.class_id, a.pid, a.supp_pids) == (b.class_id, b.pid, b.supp_pids)
        for name in ("support_images", "support_labels", "query_images", "query_labels"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                          err_msg=f"{j} {name}")
    assert set(ours.io_reads) == {"rawcache"} and ours.io_reads["rawcache"] == 2 * 8
    with pytest.raises(ValueError, match=".npy"):
        EpisodeSampler(tp["data_dir"], str(tmp_path / "split.txt"), config.Config(raw))
