"""rpnet_tpu_torch/preprocess/* against rpnet_tpu/preprocess/*.

  * morphology: the numpy half equal to the JAX module's on seeded slices
    and volumes; the torch twins equal to the JAX twins bit for bit on
    binary masks (every radius class), Otsu's threshold equal;
  * ``preprocess_patient`` on a synthetic patient in the standard layout
    writes the same files and arrays as the JAX function; ``make_splits``
    the same CSVs; the DICOM geometry (``contour_mm_to_pixels``,
    ``rasterize_contours``) equal; ``core/transforms.py``'s preprocessing
    functions (``resample``, ``truncate_HU_uint8``, ``pad2same_size(_3d)``,
    ``onehot2multi_mask``) equal;
  * offline registration: ``histogram_distance``, ``find_nearest_patient``
    and ``resample_to_reference`` equal; ``affine_register_volumes``' theta
    within 5e-5 of the JAX package's pieces run with the gather sampler
    (``fit_affine(..., sampler="gather")``, the median, the gather warp) on
    ``test_torch_registration.py``'s smooth inputs (the warp at one theta
    within 1e-5) — the JAX function itself fits with its matmul sampler,
    another trajectory from the identity theta — and on the JAX test's blob
    pair the registration closes the gap as that test requires.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpnet_tpu.core import nrrd_io as jax_nrrd_io
from rpnet_tpu.core import transforms as jax_transforms
from rpnet_tpu.preprocess import abd110 as jax_abd110
from rpnet_tpu.preprocess import dicom as jax_dicom
from rpnet_tpu.preprocess import make_splits as jax_make_splits
from rpnet_tpu.preprocess import morphology as jax_morph
from rpnet_tpu.preprocess import offline_registration as jax_offline
from rpnet_tpu_torch.core import nrrd_io, transforms
from rpnet_tpu_torch.core.synthetic import generate_dataset
from rpnet_tpu_torch.preprocess import abd110, dicom, make_splits, morphology, offline_registration

from test_torch_registration import registration_inputs

torch.set_num_threads(2)   # small shapes; the suite runs several workers on one machine


def _ct_slice(rng, H=72, W=80):
    """A body ellipse of soft tissue with a couch line, HU."""
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    body = (((yy - H / 2) / (H * 0.38)) ** 2 + ((xx - W / 2) / (W * 0.4)) ** 2) < 1
    img = np.full((H, W), -1000.0) + rng.randn(H, W) * 15
    img[body] = 40 + rng.randn(body.sum()) * 25
    img[H - 5:H - 3, 6:W - 6] = 120
    return img.astype(np.float32)


def test_morphology_numpy_half_matches_jax(rng):
    img = _ct_slice(rng)
    assert morphology.otsu_threshold(img) == jax_morph.otsu_threshold(img)
    mask = (img > morphology.otsu_threshold(img)).astype(np.uint8)
    for r in (1, 3, 7):
        for name in ("binary_closing", "binary_opening"):
            np.testing.assert_array_equal(getattr(morphology, name)(mask, r),
                                          getattr(jax_morph, name)(mask, r))
    np.testing.assert_array_equal(morphology.connected_from_seed(mask, (36, 40)),
                                  jax_morph.connected_from_seed(mask, (36, 40)))
    np.testing.assert_array_equal(morphology.connected_from_seed(mask, (0, 0)),
                                  jax_morph.connected_from_seed(mask, (0, 0)))
    np.testing.assert_array_equal(morphology.fill_holes(mask), jax_morph.fill_holes(mask))
    vol = np.stack([_ct_slice(rng) for _ in range(3)])
    got = morphology.body_mask_volume(vol, radius=5)
    np.testing.assert_array_equal(got, jax_morph.body_mask_volume(vol, radius=5))
    assert got[:, 36, 40].all() and not got[:, 69, 40].any()   # body kept, couch gone


@pytest.mark.parametrize("radius", [1, 2, 5, 7])
def test_torch_twins_match_jax_twins(radius, rng):
    masks = (rng.rand(3, 40, 52) > 0.55).astype(np.float32)
    batched = {}
    for name in ("dilate", "erode", "closing", "opening"):
        twin = getattr(morphology, f"{name}_torch")
        for m in masks:
            want = np.asarray(getattr(jax_morph, f"{name}_jax")(jnp.asarray(m), radius))
            got = twin(torch.from_numpy(m), radius).numpy()
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
        # a (D, H, W) stack goes slice by slice; uint8 and bool masks alike
        batched[name] = twin(torch.from_numpy(masks), radius).numpy()
        np.testing.assert_array_equal(
            batched[name], np.stack([twin(torch.from_numpy(m), radius).numpy() for m in masks]))
        np.testing.assert_array_equal(
            twin(torch.from_numpy(masks > 0.5), radius).numpy(), batched[name])


def test_otsu_twin_matches_jax(rng):
    for _ in range(3):
        img = np.concatenate([rng.normal(-1000, 30, 3000),
                              rng.normal(50, 30, 3000)]).reshape(60, 100).astype(np.float32)
        want = np.asarray(jax_morph.otsu_threshold_jax(jnp.asarray(img)))
        got = morphology.otsu_threshold_torch(torch.from_numpy(img)).numpy()
        assert got == want and got.dtype == want.dtype
    vol = np.stack([_ct_slice(rng) for _ in range(2)])
    assert (morphology.otsu_threshold_torch(torch.from_numpy(vol)).numpy()
            == np.asarray(jax_morph.otsu_threshold_jax(jnp.asarray(vol))))


def _standard_patient(root, pid, rng, D=5, H=64, W=64):
    """``{pid}/img.nrrd`` + ``{pid}/structures/{roi}.nrrd``, stored (x, y, z)."""
    os.makedirs(root / pid / "structures")
    vol = np.stack([_ct_slice(rng, H, W) for _ in range(D)])
    organ = np.zeros((D, H, W), np.uint8)
    organ[1:4, 24:40, 22:42] = 1
    nrrd_io.write(str(root / pid / "img.nrrd"), np.swapaxes(vol, 0, -1))
    nrrd_io.write(str(root / pid / "structures" / "Liver.nrrd"), np.swapaxes(organ, 0, -1))


def _read_all(directory):
    out = {}
    for name in sorted(os.listdir(directory)):
        path = os.path.join(directory, name)
        out[name] = (np.load(path) if name.endswith(".npy") else
                     jax_nrrd_io.read(path)[0] if name.endswith(".nrrd") else
                     open(path).read())
    return out


def test_preprocess_patient_and_splits_match_jax(tmp_path, rng):
    data = tmp_path / "standard"
    _standard_patient(data, "p000", rng)
    written = {}
    for name, module in (("jax", jax_abd110), ("torch", abd110)):
        save = str(tmp_path / f"pre_{name}")
        res = module.preprocess_patient("p000", str(data), save, roi_names=["Liver", "Spleen"])
        assert res["n_rois"] == 1
        module.write_class_csvs(save, str(tmp_path / f"classes_{name}"), roi_names=["Liver"])
        written[name] = _read_all(save)
        with open(tmp_path / f"classes_{name}" / "Liver.csv") as f:
            written[name]["Liver.csv"] = f.read().replace(f"pre_{name}", "pre")
    assert set(written["torch"]) == set(written["jax"]) == {
        "p000_bbox.npy", "p000_clean.nrrd", "p000_Liver.nrrd", "p000_masks.nrrd", "Liver.csv"}
    for k, v in written["torch"].items():
        if isinstance(v, str):
            assert v == written["jax"][k]
        else:
            np.testing.assert_array_equal(v, written["jax"][k])
            assert v.dtype == written["jax"][k].dtype, k


def test_make_splits_matches_jax(tmp_path):
    paths = generate_dataset(str(tmp_path / "d"), n_train=2, n_test=3,
                             shape=(12, 32, 32), seed=3)
    assert make_splits.discover(paths["data_dir"]) == jax_make_splits.discover(paths["data_dir"])
    files = {}
    for name, module in (("jax", jax_make_splits), ("torch", make_splits)):
        out = tmp_path / f"meta_{name}"
        res = module.make_splits(paths["data_dir"], str(out), test_frac=0.4, seed=1)
        assert (res["n_train"], res["n_test"]) == (3, 2)
        files[name] = {os.path.relpath(os.path.join(d, f), out):
                       open(os.path.join(d, f)).read()
                       for d, _, fs in os.walk(out) for f in fs}
    assert files["torch"] == files["jax"] and "classes/Liver.csv" in files["torch"]


def test_dicom_geometry_matches_jax(rng):
    pts = rng.uniform(0, 60, (12, 3))
    px = dicom.contour_mm_to_pixels(pts, origin=(-3, 2, 0), spacing=(1.5, 2.0))
    np.testing.assert_array_equal(
        px, jax_dicom.contour_mm_to_pixels(pts, origin=(-3, 2, 0), spacing=(1.5, 2.0)))
    square = np.array([[2, 2], [9, 2], [9, 9], [2, 9]])
    tri = np.array([[20, 3], [30, 15], [12, 18]])
    np.testing.assert_array_equal(dicom.rasterize_contours([square, tri, px], (40, 48)),
                                  jax_dicom.rasterize_contours([square, tri, px], (40, 48)))


def test_preprocessing_transforms_match_jax(rng):
    vol = (rng.randn(6, 20, 24) * 400).astype(np.float32)
    for spacing, new in (((2.5, 0.8, 0.8), (2.0, 2.0, 2.0)), ((1, 1, 1), (0.5, 1.5, 1.0))):
        for order in (0, 1):
            got = transforms.resample(vol, spacing, new, order=order)
            want = jax_transforms.resample(vol, spacing, new, order=order)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(transforms.truncate_HU_uint8(vol),
                                  jax_transforms.truncate_HU_uint8(vol))
    slices = [vol[0], vol[1, :13, :7], vol[2, :5]]
    for got, want in zip(transforms.pad2same_size(slices), jax_transforms.pad2same_size(slices)):
        np.testing.assert_array_equal(got, want)
    vols = [vol, vol[:3, :9], vol[:, :, :11]]
    for got, want in zip(transforms.pad2same_size_3d(vols),
                         jax_transforms.pad2same_size_3d(vols)):
        np.testing.assert_array_equal(got, want)
    onehot = (rng.rand(4, 3, 8, 8) > 0.6).astype(np.uint8)
    np.testing.assert_array_equal(transforms.onehot2multi_mask(onehot),
                                  jax_transforms.onehot2multi_mask(onehot))


def test_offline_helpers_match_jax(rng):
    a = rng.normal(0, 100, (4, 24, 24)).astype(np.float32)
    b = a + rng.normal(0, 5, a.shape).astype(np.float32)
    c = rng.normal(800, 300, a.shape).astype(np.float32)
    for x, y in ((a, b), (a, c), (b, c)):
        assert (offline_registration.histogram_distance(x, y, bins=32)
                == jax_offline.histogram_distance(x, y, bins=32))
    cands = {"close": b, "far": c, "self": a + 40}
    assert (offline_registration.find_nearest_patient(a, cands)
            == jax_offline.find_nearest_patient(a, cands))
    for order in (0, 1, 3):
        np.testing.assert_array_equal(
            offline_registration.resample_to_reference(a, (8, 12, 30), order=order),
            jax_offline.resample_to_reference(a, (8, 12, 30), order=order))


def _jax_gather_pieces(moving, fixed, iters, n_slices=5):
    """``rpnet_tpu/preprocess/offline_registration.py:54-77`` with the gather
    sampler in the fit (the function itself fits with the matmul one)."""
    from rpnet_tpu.registration.affine import affine_warp, fit_affine

    def norm01(v):
        lo, hi = np.percentile(v, [1, 99])
        return np.clip((v - lo) / max(hi - lo, 1e-6), 0, 1).astype(np.float32)

    D = min(moving.shape[0], fixed.shape[0])
    ids = np.linspace(0, D - 1, min(n_slices, D)).astype(int)
    fit = jax.jit(jax.vmap(lambda m, f: fit_affine(m, f, iters=iters, sampler="gather")[0]))
    thetas = np.asarray(fit(jnp.asarray(norm01(moving)[ids][..., None]),
                            jnp.asarray(norm01(fixed)[ids][..., None])))
    theta = np.median(thetas, axis=0)
    warp = jax.vmap(lambda x: affine_warp(x, jnp.asarray(theta)))
    return np.asarray(warp(jnp.asarray(moving)[..., None]))[..., 0], theta


@pytest.mark.parametrize("seed", [0, 1])
def test_affine_register_volumes_matches_jax_gather_pieces(seed):
    moving, _, fixed = registration_inputs(5, 64, seed)
    warped, theta = offline_registration.affine_register_volumes(moving, fixed, iters=50,
                                                                 device="cpu")
    jwarped, jtheta = _jax_gather_pieces(moving, fixed, iters=50)
    assert np.abs(theta - jtheta).max() < 5e-5, np.abs(theta - jtheta).max()
    assert np.abs(theta - np.eye(2, 3)).max() > 1e-2      # it moved
    assert warped.shape == moving.shape and warped.dtype == np.float32
    # the warp: the port's at the JAX theta is the JAX gather warp, to the
    # f32 rounding of the two affine grids' arithmetic
    from rpnet_tpu_torch.registration.affine import affine_warp

    th = torch.from_numpy(jtheta.astype(np.float32)).expand(len(moving), 2, 3)
    at_jax_theta = affine_warp(torch.from_numpy(moving)[..., None], th)[..., 0].numpy()
    np.testing.assert_allclose(at_jax_theta, jwarped, atol=1e-5)


def test_affine_register_volumes_closes_the_blob_gap():
    """``tests/test_preprocess.py``'s blob pair: 4 slices of a Gaussian blob
    at (9, 15) registered onto one at (12, 12), 40 steps."""
    yy, xx = np.meshgrid(np.arange(24), np.arange(24), indexing="ij")
    blob = lambda cy, cx: np.exp(-(((yy - cy) / 5.) ** 2 + ((xx - cx) / 5.) ** 2))
    fixed = np.stack([blob(12, 12)] * 4).astype(np.float32) * 100
    moving = np.stack([blob(9, 15)] * 4).astype(np.float32) * 100
    warped, theta = offline_registration.affine_register_volumes(moving, fixed, iters=40,
                                                                 device="cpu")
    assert np.abs(warped - fixed).mean() < 0.6 * np.abs(moving - fixed).mean()
    assert theta.shape == (2, 3)


def test_affine_register_volumes_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        offline_registration.affine_register_volumes(np.zeros((2, 8, 8), np.float32),
                                                     np.zeros((2, 8, 8), np.float32))
