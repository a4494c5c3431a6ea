"""rpnet_tpu_torch's eval modes vs the JAX package's episode function.

Both packages' episode functions (JAX: ``reg_sampler: gather``, its
torch-exact fit) run on the same numpy episode in f32 on the CPU, with the
same weights (the bridge; B=2 query slices at 32², r=2, 2 refinement
iterations, 3 affine steps), under ``use_registration_loss: False``,
``multishot_fusion`` with 2 shots (one batched fit), and ``n_way: 2``
(supports tiled over the ways, a softmax over 3 channels). Per mode: every
Dice of the packed vector within 1e-3, the NCCs within 1e-4, the prior and
the last refinement mask agreeing on more than 99.9% of pixels, and the
JAX network's refinement logits on the port's network inputs within 2e-3
of the port's. ``use_all_supports``: the port's sampler assembles the JAX
sampler's episode (one shot per support volume), which then runs through
both multishot episode functions.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpnet_tpu.config import Config as JaxConfig
from rpnet_tpu.episode.pipeline import episode_metrics_fn as jax_episode_metrics_fn
from rpnet_tpu.episode.sampler import EpisodeSampler as JaxEpisodeSampler
from rpnet_tpu_torch.config import Config
from rpnet_tpu_torch.core.synthetic import generate_dataset
from rpnet_tpu_torch.episode.pipeline import episode_metrics_fn
from rpnet_tpu_torch.episode.sampler import EpisodeSampler
from rpnet_tpu_torch.models.rpnet import RPNet
from rpnet_tpu_torch.train.convert import state_dict_from_jax

from test_torch_models import episode_inputs, jax_rpnet

torch.set_num_threads(2)   # small shapes; the suite runs several workers on one machine

H = 32
MODES = {"no_registration": dict(use_registration=False),
         "multishot": dict(multishot=True),
         "n_way": dict(n_way=2)}


@pytest.fixture(scope="module")
def pair():
    model, variables = jax_rpnet(radius=2, num_iter=2, size=H, seed=7)
    port = RPNet(radius=2, num_iter=2)
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model, variables, port.eval()


def _compare(pair, kw, supp, supl, qimg, qlab):
    """Run one episode through both packages' episode functions."""
    model, variables, port = pair
    jfn = jax.jit(jax_episode_metrics_fn(model, 3, 0, 1, "gather",
                                         compute_dtype=jnp.float32, **kw))
    ref = jfn(variables, *[jnp.asarray(a) for a in (supp, supl, qimg, qlab)],
              jnp.ones(qimg.shape[0]))
    seen = {}
    hook = port.register_forward_hook(
        lambda m, args, out: seen.update(args=args, ref=out["refinement"]))
    try:
        tfn = episode_metrics_fn(port, 3, 1, torch.float32, **kw)
        out, out_pred, out_appr = (t.numpy() for t in tfn(
            *[torch.from_numpy(a) for a in (supp, supl, qimg, qlab)],
            torch.ones(qimg.shape[0])))
    finally:
        hook.remove()

    packed = np.asarray(ref["packed_metrics"])
    assert out.shape == packed.shape == (7,)
    dice = [0, 1, 2, 5, 6]
    np.testing.assert_allclose(out[dice], packed[dice], atol=1e-3)
    np.testing.assert_allclose(out[3:5], packed[3:5], atol=1e-4)
    appr = seen["args"][4].numpy()
    last = seen["ref"][-1].numpy()
    pred = (np.exp(last[..., 1]) / np.exp(last).sum(-1)) > 0.5
    assert np.mean(appr == np.asarray(ref["appr_label"])) > 0.999
    assert np.mean(pred == np.asarray(ref["prediction"])) > 0.999
    np.testing.assert_array_equal(out_appr, appr)
    np.testing.assert_array_equal(
        out_pred, (torch.softmax(seen["ref"][-1], dim=-1)[..., 1] > 0.5).numpy())

    # the JAX network on the port's network inputs
    logits = np.asarray(jax.jit(lambda v, *a: model.apply(v, *a, train=False)["refinement"])(
        variables, *[jnp.asarray(a.numpy()) for a in seen["args"]]))
    assert logits.shape == seen["ref"].shape
    np.testing.assert_allclose(seen["ref"].numpy(), logits, atol=2e-3)
    return seen["args"]


@pytest.mark.parametrize("mode", list(MODES))
def test_episode_modes_match(pair, mode):
    s_img, s_lab, q_img, q_lab = episode_inputs(4, H, seed=8)
    supp, supl = s_img.reshape(2, 2, H, H), s_lab.reshape(2, 2, H, H)
    args = _compare(pair, MODES[mode], supp, supl, q_img[:2], np.roll(q_lab[:2], 2, -1))
    supp_t, fore = args[0], args[1]
    if mode == "no_registration":   # the raw support and label feed the network
        np.testing.assert_array_equal(supp_t.numpy()[0, 0, ..., 0], supp[0])
        np.testing.assert_array_equal(args[4].numpy(), supl[0])
    elif mode == "multishot":       # every shot registered, fused by the mean
        assert tuple(fore.shape) == (1, 2, 2, H, H)
    else:                           # ways tile the supports
        assert tuple(fore.shape) == (2, 1, 2, H, H)
        assert torch.equal(fore[0], fore[1])


def test_use_all_supports_matches_jax(pair, tmp_path):
    paths = generate_dataset(str(tmp_path / "data"), n_train=1, n_test=3,
                             shape=(10, 40, 40), classes=("Liver",), seed=9)
    raw = dict(data_dir=paths["data_dir"], class_csv_dir=paths["class_dir"],
               eval_set_name=paths["test_csv"], train_set_name=paths["train_csv"],
               num_slice=16, num_x=40, num_y=40, crop_size=[H, H], k=2, n_shot=2,
               eval_classes=["Liver"], train_classes=["Liver"],
               use_all_supports=True, multishot_fusion=True)
    ours = EpisodeSampler(paths["data_dir"], paths["test_csv"], Config(raw))
    ref = JaxEpisodeSampler(paths["data_dir"], paths["test_csv"], JaxConfig(raw),
                            mode="eval")
    random.seed(1)
    picks = ours.draw_supports(0)
    ep = ours.sample(0, picks=picks)
    jep = ref.sample(0, picks=picks)
    assert ep.support_images.shape[0] == 2     # one shot per support volume
    for name in ("support_images", "support_labels", "query_images", "query_labels"):
        np.testing.assert_array_equal(getattr(ep, name), getattr(jep, name), err_msg=name)
    _compare(pair, dict(multishot=True), ep.support_images[:, :2], ep.support_labels[:, :2],
             ep.query_images[:2], ep.query_labels[:2])
