"""rpnet_tpu_torch/core/boxes.py and episode/brain.py against the JAX
package's modules (both numpy and scipy; copies).

  * every ``boxes`` function on seeded inputs, equal;
  * ``elastic_transform`` / ``elastic_transform_all`` equal under the same
    ``RandomState``;
  * ``BrainReader`` train, eval and test samples equal after the same
    ``np.random.seed``: ``Crop``'s jitter and the train mode's elastic coin
    draw from the global numpy stream, which both readers consume in the
    same order (the data of ``tests/test_brain.py``). The elastic field
    itself comes from ``np.random.RandomState(None)`` in both packages (OS
    entropy, as the reference's gist draws it), so the train case seeds
    that one state for both readers.
"""

import numpy as np
import pytest
import torch

from rpnet_tpu.config import Config as JaxConfig
from rpnet_tpu.core import boxes as jax_boxes
from rpnet_tpu.core import nrrd_io
from rpnet_tpu.episode import brain as jax_brain
from rpnet_tpu_torch.config import Config
from rpnet_tpu_torch.core import boxes
from rpnet_tpu_torch.episode import brain

torch.set_num_threads(2)   # small shapes; the suite runs several workers on one machine


def _equal(a, b):
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype


def _masks(rng, C=3, D=6, H=20, W=24):
    m = np.zeros((C, D, H, W), np.float32)
    for c in range(C - 1):      # the last class stays empty
        z, y, x = rng.randint(0, D - 3), rng.randint(0, H - 8), rng.randint(0, W - 8)
        m[c, z:z + 3, y:y + rng.randint(3, 8), x:x + rng.randint(3, 8)] = 1
    return m


def test_boxes_match_jax(rng):
    dets = np.concatenate([rng.rand(12, 1), rng.rand(12, 3) * 20,
                           rng.rand(12, 3) * 6 + 2], axis=1)
    for thresh in (0.1, 0.3, 0.7):
        assert boxes.py_nms(dets, thresh) == jax_boxes.py_nms(dets, thresh)
    _equal(boxes.py_box_overlap(dets[:5, 1:], dets[:, 1:]),
           jax_boxes.py_box_overlap(dets[:5, 1:], dets[:, 1:]))
    centers = np.abs(rng.randn(6, 6)) * 10 + 5
    _equal(boxes.center_box_to_coord_box(centers), jax_boxes.center_box_to_coord_box(centers))
    _equal(boxes.coord_box_to_center_box(centers), jax_boxes.coord_box_to_center_box(centers))
    coords = rng.randint(0, 40, (6, 6))
    _equal(boxes.ext2factor(coords, 8), jax_boxes.ext2factor(coords, 8))
    _equal(boxes.clip_boxes(coords * 1.5, (20, 30, 40)),
           jax_boxes.clip_boxes(coords * 1.5, (20, 30, 40)))

    masks = _masks(rng)
    rois = {"A": masks[0], "B": masks[1] * 3}
    _equal(boxes.annotation2masks(rois, ["A", "B", "C"]),
           jax_boxes.annotation2masks(rois, ["A", "B", "C"]))
    _equal(boxes.masks2bboxes_masks(masks, border=2), jax_boxes.masks2bboxes_masks(masks, border=2))
    _equal(boxes.get_contours_from_masks(masks), jax_boxes.get_contours_from_masks(masks))
    overlap = masks.copy()
    overlap[1] = np.maximum(overlap[1], overlap[0])   # overlaps: the later class wins
    _equal(boxes.merge_contours(boxes.get_contours_from_masks(overlap)),
           jax_boxes.merge_contours(jax_boxes.get_contours_from_masks(overlap)))
    _equal(boxes.merge_masks(overlap), jax_boxes.merge_masks(overlap))

    dets7 = [[3, 10, 12, 4, 8, 6, 1], [2.5, 5, 5, 3, 5, 4, 2]]
    crops = [rng.rand(4, 8, 6), rng.rand(3, 5, 4)]
    _equal(boxes.detections2mask(dets7, crops, (8, 20, 24), num_class=3),
           jax_boxes.detections2mask(dets7, crops, (8, 20, 24), num_class=3))
    cboxes = [[0, 2, 3, 4, 10, 9, 1], [2, 8, 8, 5, 13, 12, 3]]
    crops = [rng.rand(4, 8, 6), rng.rand(3, 5, 4)]
    _equal(boxes.crop_boxes2mask(cboxes, crops, (8, 20, 24), num_class=3),
           jax_boxes.crop_boxes2mask(cboxes, crops, (8, 20, 24), num_class=3))


@pytest.mark.parametrize("fn", ["elastic_transform", "elastic_transform_all"])
def test_elastic_transform_matches_jax(fn, rng):
    img = rng.randn(1, 4, 32, 36).astype(np.float32)
    masks = _masks(rng, D=4, H=32, W=36)
    for seed, kw in ((0, dict(alpha=100)), (1, dict(alpha=300, sigma=10, alpha_affine=0.5))):
        got = getattr(brain, fn)(img, masks, random_state=np.random.RandomState(seed), **kw)
        want = getattr(jax_brain, fn)(img, masks, random_state=np.random.RandomState(seed), **kw)
        _equal(got, want)
        assert not np.array_equal(got[0], img)   # it moved


@pytest.fixture(scope="module")
def brain_dataset(tmp_path_factory):
    """``tests/test_brain.py``'s two 12×48×48 volumes with a BrainStem ROI."""
    root = tmp_path_factory.mktemp("brain")
    rng = np.random.RandomState(0)
    pids = ["b000", "b001"]
    for pid in pids:
        vol = (rng.randn(12, 48, 48) * 30).astype(np.int16)
        nrrd_io.write(str(root / f"{pid}_clean.nrrd"), vol)
        m = np.zeros((12, 48, 48), np.uint8)
        m[3:9, 14:30, 16:32] = 1
        nrrd_io.write(str(root / f"{pid}_BrainStem.nrrd"), m)
    split = root / "split.csv"
    split.write_text("\n".join(pids) + "\n")
    return str(root), str(split)


_CFG = {"num_slice": 16, "num_x": 48, "num_y": 48, "train_max_crop_size": [16, 48, 48],
        "pad_value": -1024, "jitter_range": [1, 2, 2], "HU_range": [-1024, 3072],
        "bbox_border": 2, "do_elastic": True, "roi_names": ["BrainStem"]}


def _seed_elastic_field(monkeypatch, field_seed):
    """Fix the elastic field's ``RandomState(None)`` (OS entropy) to
    ``field_seed`` in both packages."""
    state = np.random.RandomState

    def seeded_state(seed=None):
        return state(field_seed if seed is None else seed)

    monkeypatch.setattr(np.random, "RandomState", seeded_state)


@pytest.mark.parametrize("mode", ["train", "eval", "test"])
def test_brain_reader_matches_jax(brain_dataset, mode, monkeypatch):
    data_dir, split = brain_dataset
    _seed_elastic_field(monkeypatch, 1234)
    samples = {}
    for name, module in (("jax", jax_brain), ("torch", brain)):
        np.random.seed(5)
        reader = module.BrainReader(data_dir, split, dict(_CFG), mode=mode)
        # 6 draws: the elastic coin lands both ways over them in train mode
        samples[name] = [reader[i % len(reader)] for i in range(6)]
    _equal(samples["torch"], samples["jax"])
    if mode == "train":
        firsts = [s[0] for s in samples["torch"]]
        assert any(not np.array_equal(firsts[0], f) for f in firsts[2::2])


def test_brain_reader_runs_from_the_port_config_defaults(brain_dataset, monkeypatch):
    """The port's ``Config`` carries the brain keys' defaults (the JAX
    package's): a config with none of them reads a sample (the elastic
    field seeded, as the sample depends on it; see the next test)."""
    data_dir, split = brain_dataset
    cfg = Config({"num_slice": 16, "num_x": 48, "num_y": 48, "roi_names": ["BrainStem"]})
    assert cfg["jitter_range"] == [4, 16, 16] and cfg["bbox_border"] == 8
    _seed_elastic_field(monkeypatch, 1234)
    np.random.seed(0)
    inp, bboxes, labels, tmasks, masks = brain.BrainReader(data_dir, split, cfg, mode="train")[0]
    assert inp.shape[0] == 1 and labels[0] == 1 and tmasks.shape[0] == 1


@pytest.mark.parametrize("field_seed", [0, 7])
def test_an_elastic_field_can_erase_the_roi_in_both_packages(brain_dataset, monkeypatch,
                                                             field_seed):
    """A fault of the JAX reader that the copy keeps: at these defaults on
    48² crops, some elastic fields (8 of field seeds 0-39) move the whole
    ROI out of the crop, and ``__getitem__`` raises ``IndexError`` on the
    empty box list, in both packages alike (ROADMAP queue 3)."""
    data_dir, split = brain_dataset
    _seed_elastic_field(monkeypatch, field_seed)
    for module, config in ((jax_brain, JaxConfig), (brain, Config)):
        cfg = config({"num_slice": 16, "num_x": 48, "num_y": 48, "roi_names": ["BrainStem"]})
        np.random.seed(0)
        with pytest.raises(IndexError, match="too many indices"):
            module.BrainReader(data_dir, split, cfg, mode="train")[0]
