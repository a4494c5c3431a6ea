"""Serving in the port alone (no JAX): the correlation custom ops, the
exported episode program (``rpnet_tpu_torch/serve/export.py``) against the
live episode function, weights served as inputs, and the loader's refusals.
The served CLI against the JAX package's live eval CLI is
``tests/test_torch_cli.py::test_serve_cli_matches_jax``."""

import copy
import json
import os
import shutil

import numpy as np
import pytest
import torch

from rpnet_tpu_torch.config import Config
from rpnet_tpu_torch.episode.pipeline import EpisodeRunner, episode_metrics_fn
from rpnet_tpu_torch.episode.sampler import Episode
from rpnet_tpu_torch.models.factory import build_rpnet
from rpnet_tpu_torch.serve import export as se

torch.set_num_threads(2)   # small shapes; the suite runs several workers on one machine

SIZE, DQ, ITERS, AFFINE = 32, 8, 2, 4
CFG = dict(crop_size=[SIZE, SIZE], mask_refinement_correlation_radius=2, backbone="UNet")


def _corr_inputs(seed, shape=(2, 6, 8, 16), dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g).to(dtype),
            torch.randn(shape, generator=g).to(dtype))


def _csub_args():
    a, b = _corr_inputs(4)
    return a.transpose(2, 3).contiguous(), b.transpose(2, 3).contiguous(), 2


OPS = {"local_corr": lambda: (*_corr_inputs(0), 2),
       "local_corr_band": lambda: (*_corr_inputs(1), 1),
       "local_corr_pdot": lambda: (*_corr_inputs(2, dtype=torch.bfloat16), 2),
       "local_corr_packed": lambda: (*_corr_inputs(3), 2, 4),
       "local_corr_csub": _csub_args}


@pytest.mark.parametrize("name", list(OPS))
def test_correlation_custom_op(name):
    """Schema, fake implementation, autograd registration and tracing of each
    forward's custom op; on CPU tensors it is the plain version."""
    op = getattr(torch.ops.rpnet_torch, name).default
    args = OPS[name]()
    torch.library.opcheck(op, args)
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        out = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args))
        fake = (tuple(out.shape), out.dtype)
    real = op(*args)
    assert fake == (tuple(real.shape), real.dtype)


def _episode(seed, dq=DQ):
    """Support and query slices with blob labels, as f32 tensors."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[:SIZE, :SIZE]

    def blob(n):
        c = rs.uniform(10, 22, (n, 2))
        lab = ((yy - c[:, :1, None]) ** 2 + (xx - c[:, 1:, None]) ** 2 < 49).astype(np.float32)
        return lab, np.clip(lab + 0.2 * rs.randn(n, SIZE, SIZE), -1, 1).astype(np.float32) - 0.5

    sl, si = blob(dq)
    ql, qi = blob(dq)
    return (torch.from_numpy(si[None]), torch.from_numpy(sl[None]), torch.from_numpy(qi),
            torch.from_numpy(ql), torch.ones(dq))


def _live(model, arrays, dtype):
    net = copy.deepcopy(model).to(dtype).eval()
    with torch.no_grad():
        return episode_metrics_fn(net, AFFINE, 1, dtype)(*arrays)


def _weights(model, names):
    sd = model.state_dict()
    return tuple(sd[n].float() for n in names)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """One bf16 export at 32², DQ = 8, 2 refinement iterations, 4 affine
    steps, saved and loaded back."""
    model = build_rpnet(CFG, num_iter=ITERS, seed=3)
    exported = se.export_episode_program(model, slices=DQ, height=SIZE, width=SIZE,
                                         affine_iters=AFFINE, fit_scale=1, device="cpu")
    path = str(tmp_path_factory.mktemp("artifact") / "art")
    se.save_artifact(exported, path, se.weight_names(model), {"net": "RP_Net"})
    return model, exported, path, se.load_artifact(path, "cpu")


def test_round_trip_matches_live_episode(artifact):
    """Saved and reloaded, the program gives the live episode function's
    packed metrics, mask and prior bit for bit (bf16 network)."""
    model, _, _, program = artifact
    arrays = _episode(0)
    out = program(_weights(model, program.manifest["weights"]), *arrays)
    ref = _live(model, arrays, torch.bfloat16)
    assert [o.shape for o in out] == [torch.Size([5 + ITERS]), (DQ, SIZE, SIZE), (DQ, SIZE, SIZE)]
    for o, r in zip(out, ref):
        assert torch.isfinite(o).all()
        torch.testing.assert_close(o, r, rtol=0, atol=1e-6)


def test_weights_are_inputs(artifact):
    """Weights written after the export serve without exporting again, and
    the program holds no weight as state or a constant."""
    _, exported, _, program = artifact
    other = build_rpnet(CFG, num_iter=ITERS, seed=11)
    arrays = _episode(1)
    out = program(_weights(other, program.manifest["weights"]), *arrays)
    ref = _live(other, arrays, torch.bfloat16)
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, rtol=0, atol=1e-6)
    assert not exported.state_dict
    assert sum(t.numel() for t in exported.constants.values()) < 4096   # resize matrices


def test_graph_holds_the_correlation_custom_op(artifact):
    """The correlation is the custom op (one node a support and an
    iteration), not its plain version traced into aten operations."""
    _, exported, _, program = artifact
    assert se.correlation_ops(exported) == {"rpnet_torch.local_corr.default": 1 + ITERS}
    man = program.manifest
    assert man["correlation_ops"] == {"rpnet_torch.local_corr.default": 1 + ITERS}
    assert (man["slices"], man["shots"], man["crop_size"], man["device_type"]) == \
        (DQ, 1, [SIZE, SIZE], "cpu")
    targets = {str(n.target) for n in se.graph_nodes(exported)}
    assert "aten.grid_sampler_2d_backward.default" in targets   # the fit is in the graph


def test_artifact_runner_pads_short_episodes(artifact):
    """Through the runner: an episode of 6 slices padded to the program's 8
    (slice_mask 0) settles as the live runner settles it."""
    model, _, _, program = artifact
    cfg = Config(dict(CFG, reg_affine_iters=AFFINE, reg_fit_scale=1))
    supp, slab, qry, qlab, _ = _episode(2, dq=6)
    ep = Episode(supp.numpy(), slab.numpy(), qry.numpy(), qlab.numpy(), 0, "q", [(0, 0)])
    served = se.make_artifact_runner(program, model.state_dict(), cfg, "cpu")
    live = EpisodeRunner(copy.deepcopy(model), cfg, "cpu")
    a, b = served.finalize(served.dispatch(ep, arrays=True)), live.finalize(live.dispatch(ep, arrays=True))
    assert a["prediction"].shape == b["prediction"].shape == (6, SIZE, SIZE)
    np.testing.assert_array_equal(a["appr_label"], b["appr_label"])
    assert (a["prediction"] == b["prediction"]).mean() > 0.999
    for key in ("dsc_affine", "dsc_fewshot", "ncc_warped", "ncc_raw"):
        assert abs(a[key] - b[key]) < 1e-3, key
    with pytest.raises(ValueError, match="does not cover"):
        se.make_artifact_runner(program, {}, cfg, "cpu")


def test_padded_live_runner_matches_the_program(artifact):
    """The live runner padding to the program's slices (``slices``) feeds
    the episode function the program's inputs: the two settle the same
    6-slice episode alike, metrics within 1e-6 and masks equal."""
    model, _, _, program = artifact
    cfg = Config(dict(CFG, reg_affine_iters=AFFINE, reg_fit_scale=1))
    supp, slab, qry, qlab, _ = _episode(5, dq=6)
    ep = Episode(supp.numpy(), slab.numpy(), qry.numpy(), qlab.numpy(), 0, "q", [(0, 0)])
    served = se.make_artifact_runner(program, model.state_dict(), cfg, "cpu")
    live = EpisodeRunner(copy.deepcopy(model), cfg, "cpu", slices=DQ)
    a, b = served.finalize(served.dispatch(ep, arrays=True)), live.finalize(live.dispatch(ep, arrays=True))
    for key in ("prediction", "appr_label"):
        np.testing.assert_array_equal(a[key], b[key])
    for key in ("dsc_affine", "dsc_fewshot", "ncc_warped", "ncc_raw"):
        assert abs(a[key] - b[key]) <= 1e-6, key
    assert all(abs(a["dsc_refinement"][i] - b["dsc_refinement"][i]) <= 1e-6
               for i in range(ITERS))


def test_device_tensor_cache_is_bypassed_while_tracing():
    """A constant made while a fake-tensor mode is active (an export's
    trace) is not cached, so no fake tensor reaches a live call; outside
    one the constant is made once."""
    from rpnet_tpu_torch.utils.tensor_cache import device_tensor_cache

    made = []

    @device_tensor_cache
    def ramp(n, device):
        made.append(n)
        return torch.arange(n, device=device, dtype=torch.float32)

    with torch._subclasses.fake_tensor.FakeTensorMode():
        traced = ramp(3, torch.device("cpu"))
    assert isinstance(traced, torch._subclasses.fake_tensor.FakeTensor)
    assert ramp.cache_info().currsize == 0
    live = ramp(3, torch.device("cpu"))
    assert ramp(3, torch.device("cpu")) is live and made == [3, 3]
    assert not isinstance(live, torch._subclasses.fake_tensor.FakeTensor)


def test_load_artifact_refuses(artifact, tmp_path):
    """A newer format, a missing or corrupt program and another device type
    raise; another torch major version warns."""
    path = artifact[2]

    def copy_with(name, manifest=None, program=None):
        d = str(tmp_path / name)
        shutil.copytree(path, d)
        if manifest is not None:
            with open(os.path.join(d, se.MANIFEST_FILE)) as f:
                man = json.load(f)
            man.update(manifest)
            with open(os.path.join(d, se.MANIFEST_FILE), "w") as f:
                json.dump(man, f)
        if program is not None:
            with open(os.path.join(d, se.PROGRAM_FILE), "wb") as f:
                f.write(program)
        return d

    with pytest.raises(ValueError, match="format"):
        se.load_artifact(copy_with("newer", {"format_version": se.FORMAT_VERSION + 1}), "cpu")
    missing = copy_with("missing")
    os.remove(os.path.join(missing, se.PROGRAM_FILE))
    with pytest.raises(FileNotFoundError):
        se.load_artifact(missing, "cpu")
    with pytest.raises(ValueError, match="not a loadable program"):
        se.load_artifact(copy_with("corrupt", program=b"PK\x03\x04 not a program"), "cpu")
    with pytest.raises(ValueError, match="exported for 'cpu'"):
        se.load_artifact(path, "cuda")
    # the warning comes before the program is read (a corrupt one here)
    with pytest.warns(UserWarning, match="torch 1.0"), pytest.raises(ValueError):
        se.load_artifact(copy_with("old", {"torch_version": "1.0.0"}, b"PK"), "cpu")
