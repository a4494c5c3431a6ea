"""In-process sharding of rpnet_tpu_torch (``parallel/mesh.py`` and its
callers) against the JAX package's, on the same seeded numpy inputs: the JAX
package on the suite's 8 virtual CPU devices, the port on logical devices
(``make_mesh(..., devices=[cpu] * n)``), which run the sharded code path on
one device:

  * the mesh: logical devices, the grid, the layouts, and the
    tensor-parallel rule (``shard_params``) against the JAX rule's choice
    per converted leaf;
  * RP_Net eval: the sharded ``EpisodeRunner`` ≡ the one-device runner ≡
    the JAX runner over ``{data: 8}`` on the episode of
    ``tests/test_parallel.py::test_sharded_episode_matches_single_device``
    (Dice 1e-4); the eval CLI's spec and host paths under ``{data: 8}`` bit
    for bit; the eval CLI with ``mesh_shape: {data: 2}`` on two devices
    against the JAX CLI on two (per-class Dice 1e-3, the same ``[mesh ...]``
    line); ``eval_3d`` windows over ``{data: 3}`` against one device;
  * LGCA: ``sharded_lgca_train_step`` over ``{data: 4}`` ≡ the one-device
    step (f64, SGD: losses, parameters and running statistics to 1e-9 of
    their scale) ≡ the JAX sharded step (f32 Adam, 2 steps: loss rtol 1e-3,
    parameters atol 5e-3, as ``tests/test_lgca.py`` holds its own); the
    sharded ``evaluate_lgca_volume`` (the chunk rounded to a multiple of the
    data axis) within 1e-3 of the one-device and the JAX sharded eval; the
    same step with batch statistics per shard (a data-parallel copy)
    outside those bounds; both LGCA CLIs with ``mesh_shape: {data: 2}`` on
    two devices (the JAX CLIs' ``[LGCA mesh ...]`` lines, the one-device
    CLIs' loss and Dice);
  * RP_Net training: ``sharded_train_step`` over ``{data: 4, model: 2}`` ≡
    the one-device step with the registration prior, in f64 (SGD at lr 1:
    the parameter change is the gradient; to 1e-9 of its scale), and its f32
    loss within 1e-4 of the JAX ``sharded_train_step`` on the same mesh
    shape.

Each JAX program compiles once (module fixtures); the port's CPU side runs
in a few seconds a case.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from rpnet_tpu.cli import test_rpnet as jax_cli
from rpnet_tpu.core.synthetic import generate_dataset
from rpnet_tpu.episode.pipeline import EpisodeRunner as JaxEpisodeRunner
from rpnet_tpu.episode.sampler import Episode as JaxEpisode
from rpnet_tpu.models import lgca as jl
from rpnet_tpu.models.rpnet import RPNet as JaxRPNet
from rpnet_tpu.parallel import mesh as jax_mesh
from rpnet_tpu.train.lgca import evaluate_lgca_volume as jax_evaluate_lgca_volume
from rpnet_tpu.train.lgca import sharded_lgca_train_step as jax_sharded_lgca_train_step
from rpnet_tpu.train.trainer import make_optimizer as jax_make_optimizer
from rpnet_tpu.train.trainer import sharded_train_step as jax_sharded_train_step
from rpnet_tpu_torch.cli import test_rpnet as torch_cli
from rpnet_tpu_torch.cli import train as torch_train_cli
from rpnet_tpu_torch.episode.pipeline import EpisodeRunner
from rpnet_tpu_torch.episode.sampler import Episode
from rpnet_tpu_torch.models import lgca as tl
from rpnet_tpu_torch.models.rpnet import RPNet
from rpnet_tpu_torch.parallel import mesh
from rpnet_tpu_torch.train.convert import lgca_state_dict_from_jax, state_dict_from_jax
from rpnet_tpu_torch.train.lgca import (_lgca_step, evaluate_lgca_volume,
                                        make_lgca_train_step, sharded_lgca_train_step)
from rpnet_tpu_torch.train.trainer import (make_optimizer, make_train_step,
                                           sharded_train_step)

import test_torch_lgca_cli as lgca_cli
from test_torch_lgca import FS, K, inputs, random_lgca_variables
from test_torch_models import jax_rpnet, tensorboard_without_tensorflow  # noqa: F401

torch.set_num_threads(2)   # small shapes; the suite runs several workers on one machine

CPU = torch.device("cpu")
H, R, T = 32, 1, 2


def logical(shape):
    n = int(np.prod(list(shape.values())))
    return mesh.make_mesh(shape, devices=[CPU] * n)


def jax_mesh_of(shape):
    n = int(np.prod(list(shape.values())))
    return jax_mesh.make_mesh(shape, devices=jax.devices()[:n])


@pytest.fixture(scope="module")
def rpnet_weights():
    """A JAX RPNet's numpy variables (U-Net d4, radius 1), randomized norms."""
    return jax_rpnet(radius=R, num_iter=T, size=H, seed=5)[1]


def port_rpnet(variables, num_iter=T, train=False):
    port = RPNet(radius=R, num_iter=num_iter, align=True, soft_mask=train)
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    return port.train() if train else port.eval()


# ---------------------------------------------------------------- the mesh

def test_make_mesh_takes_logical_devices():
    m = logical({"data": 4, "model": 2})
    assert m.shape == {"data": 4, "model": 2} and m.size == 8
    assert m.rows == [[CPU] * 2] * 4 and m.data_devices == [CPU] * 4 and m.first == CPU
    # the real devices are still one CPU, and a mesh of two needs two
    assert mesh.local_devices() == mesh.local_devices("cpu") == [CPU]
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        mesh.resolve_local_mesh({"data": 2})
    x = torch.arange(7 * 3.0).reshape(7, 3)
    parts = mesh.shard_slices(logical({"data": 3}), x)
    assert [p.shape[0] for p in parts] == [3, 2, 2]       # torch.tensor_split's split
    assert torch.equal(mesh.gather_slices(parts, CPU), x)
    assert [p.shape[0] for p in mesh.shard_slices(logical({"data": 8}), x)] == [1] * 7
    copies = mesh.replicated(logical({"data": 3}), x)
    assert len(copies) == 3 and all(c is copies[0] for c in copies)   # one a device


def test_shard_params_matches_the_jax_rule(rpnet_weights):
    """The tensor-parallel rule picks the same weights in both packages:
    each JAX kernel leaf is filled with 1 where the JAX rule shards it over
    ``model`` (0 elsewhere), carried through the bridge, and read against
    the port's placement of the converted name."""
    jmesh = jax_mesh_of({"data": 4, "model": 2})
    shardings = jax_mesh.shard_params(rpnet_weights["params"], jmesh)
    flags = jax.tree_util.tree_map(
        lambda leaf, s: np.full(np.shape(leaf), float("model" in str(s.spec)), np.float32),
        rpnet_weights["params"], shardings)
    converted = state_dict_from_jax({"params": flags,
                                     "batch_stats": rpnet_weights["batch_stats"]})
    port = port_rpnet(rpnet_weights)
    placement = mesh.shard_params(port, logical({"data": 4, "model": 2}))
    assert set(placement) == set(port.state_dict())
    params = dict(port.named_parameters())
    want = {n for n in params if converted[n].numel() and bool(converted[n].min() == 1)}
    got = {n for n, where in placement.items() if where == "model"}
    # both convs of Conv3..5, Up_conv5/4; Up5, Up4; the CRE's w_k, w_q
    assert got == want and len(got) == 14
    assert all(converted[n].max() == 0 for n in params if n not in got)
    assert set(mesh.shard_params(port, logical({"data": 8})).values()) == {"replicated"}


# ---------------------------------------------------------------- RP_Net eval

def _episode(cls):
    """tests/test_parallel.py::test_sharded_episode_matches_single_device's."""
    Dq = 6
    yy, xx = np.meshgrid(np.arange(H), np.arange(H), indexing="ij")
    organ = lambda cy, cx: ((((yy - cy) / 10) ** 2 + ((xx - cx) / 8) ** 2) < 1)
    sl = organ(15, 14).astype(np.float32)
    ql = organ(17, 17).astype(np.float32)
    return cls(
        support_images=(np.repeat(sl[None], Dq, 0) * 0.8 - 0.5)[None].astype(np.float32),
        support_labels=np.repeat(sl[None], Dq, 0)[None].astype(np.float32),
        query_images=(np.repeat(ql[None], Dq, 0) * 0.8 - 0.5).astype(np.float32),
        query_labels=np.repeat(ql[None], Dq, 0).astype(np.float32),
        class_id=0, pid="x", supp_pids=[(0, 0)])


EVAL_CFG = {"backbone": "UNet", "crop_size": [H, H], "k": 2, "n_iter_refinement": T,
            "mask_refinement_correlation_radius": R, "reg_affine_iters": 3,
            "reg_sampler": "gather", "do_deformable": False, "slice_bucket": 8,
            "max_slices": 16, "compute_dtype": "float32"}


def _dice(res):
    return [res["dsc_affine"], res["dsc_fewshot"], *res["dsc_refinement"].values()]


def test_sharded_runner_matches_one_device_and_jax(rpnet_weights):
    jmodel = JaxRPNet(backbone="UNet", num_iter=T, radius=R, align=False, use_pallas=False)
    ref = JaxEpisodeRunner(jmodel, rpnet_weights, EVAL_CFG,
                           mesh=jax_mesh_of({"data": 8})).run(_episode(JaxEpisode))
    one = EpisodeRunner(port_rpnet(rpnet_weights), EVAL_CFG, "cpu").run(_episode(Episode))
    sharded = EpisodeRunner(port_rpnet(rpnet_weights), EVAL_CFG, "cpu",
                            mesh=logical({"data": 8}))
    got = sharded.run(_episode(Episode))
    assert (sharded.bucket, sharded.max_slices) == (8, 16)
    assert sharded._bounds(6) == [(i, i + 1) for i in range(6)]   # two devices idle
    assert sharded.shard_launches == [0] * 8   # the plain versions count no launch
    np.testing.assert_allclose(_dice(got), _dice(one), atol=1e-4)
    np.testing.assert_allclose(_dice(got), _dice(ref), atol=1e-4)
    for key in ("ncc_warped", "ncc_raw"):
        assert got[key] == pytest.approx(ref[key], abs=1e-4)
    # a data axis of 4 over the model axis: each row's first device runs it
    rows = EpisodeRunner(port_rpnet(rpnet_weights), EVAL_CFG, "cpu",
                         mesh=logical({"data": 4, "model": 2})).run(_episode(Episode))
    np.testing.assert_allclose(_dice(rows), _dice(one), atol=1e-4)


def _cli_config(paths, out_dir, ckpt, **kw):
    cfg = dict(
        data_dir=paths["data_dir"], class_csv_dir=paths["class_dir"],
        eval_set_name=paths["test_csv"], train_set_name=paths["train_csv"],
        num_slice=32, num_x=48, num_y=48, crop_size=[32, 32], pad_value=-1024,
        HU_range=[-1024, 3072], n_shot=1, n_way=1, k=4, eval_classes=["Liver"],
        train_classes=["Spleen"], backbone="UNet", n_iter_refinement=2,
        n_test_iter_refinement=2, mask_refinement_correlation_radius=2, soft_mask=False,
        do_deformable=False, reg_affine_iters=4, reg_sampler="gather",
        slice_bucket=8, max_slices=16, do_intaug=False, do_elastic=False, n_runs=1,
        out_dir=out_dir, ckpt=ckpt, compute_dtype="float32")
    cfg.update(kw)
    return cfg


@pytest.fixture(scope="module")
def eval_data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_cli")
    paths = generate_dataset(str(tmp / "data"), n_train=3, n_test=3, shape=(20, 48, 48),
                             seed=0)
    _, variables = jax_rpnet(radius=2, num_iter=2, size=32, seed=3)
    ckpt = str(tmp / "shared.pth")
    torch.save({"epoch": 0, "state_dict": state_dict_from_jax(variables)}, ckpt)
    return tmp, paths, ckpt


def _run_cli(cli, tmp, name, cfg, extra):
    ypath = str(tmp / f"{name}.yml")
    with open(ypath, "w") as f:
        yaml.safe_dump(cfg, f)
    stdout = sys.stdout
    try:
        cli.main(["--yaml", ypath, *extra])
    finally:
        sys.stdout = stdout   # the JAX CLI leaves its log tee installed
    with open(f"{cfg['out_dir']}/results_eval.json") as f:
        results = json.load(f)
    with open(f"{cfg['out_dir']}/log_eval") as f:
        lines = [l for l in f.read().splitlines() if l.startswith("[mesh ")]
    return results, lines


@pytest.mark.usefixtures("tensorboard_without_tensorflow")
def test_spec_and_host_paths_agree_under_data_8(eval_data, monkeypatch):
    """``tests/test_episode.py::test_device_cache_spec_path_sharded_matches_host``
    on the port: the index-only episodes (volumes cached on every data
    device, each gathering its rows) and the host-assembled ones give the
    same per-class numbers, bit for bit."""
    tmp, paths, ckpt = eval_data
    monkeypatch.setattr(mesh, "local_devices", lambda device_type=None: [CPU] * 8)
    runs = {}
    for tag, cache in (("spec", 16), ("host", 0)):
        cfg = _cli_config(paths, str(tmp / f"d8_{tag}"), ckpt, device_volume_cache=cache,
                          mesh_shape={"data": 8, "model": 1})
        runs[tag] = _run_cli(torch_cli, tmp, f"d8_{tag}", cfg, ["--platform", "cpu"])
    (a, la), (b, lb) = runs["spec"], runs["host"]
    assert a["episodes"] == b["episodes"] > 0
    assert a["failed_episodes"] == 0 == b["failed_episodes"]
    assert a["classes"] == b["classes"]
    assert la == lb == ["[mesh {'data': 8, 'model': 1} over 8 local devices]"]


@pytest.mark.usefixtures("tensorboard_without_tensorflow")
def test_eval_cli_on_two_devices_matches_jax(eval_data, monkeypatch):
    tmp, paths, ckpt = eval_data
    shape = {"data": 2}
    two = jax.devices()[:2]
    monkeypatch.setattr(jax, "local_devices", lambda *a, **k: two)
    want, want_lines = _run_cli(jax_cli, tmp, "jax2",
                                _cli_config(paths, str(tmp / "jax2"), ckpt, mesh_shape=shape),
                                ["--platform", "cpu"])
    monkeypatch.setattr(mesh, "local_devices", lambda device_type=None: [CPU] * 2)
    got, got_lines = _run_cli(torch_cli, tmp, "port2",
                              _cli_config(paths, str(tmp / "port2"), ckpt, mesh_shape=shape),
                              ["--platform", "cpu"])
    assert got_lines == want_lines == ["[mesh {'data': 2, 'model': 1} over 2 local devices]"]
    assert got["episodes"] == want["episodes"] > 0 and got["failed_episodes"] == 0
    for cls, ref in want["classes"].items():
        np.testing.assert_allclose(got["classes"][cls]["affine"], ref["affine"], atol=1e-3)
        np.testing.assert_allclose(got["classes"][cls]["fewshot"], ref["fewshot"], atol=1e-3)
        for it, v in ref["refinement"].items():
            np.testing.assert_allclose(got["classes"][cls]["refinement"][it], v, atol=1e-3)


@pytest.mark.usefixtures("tensorboard_without_tensorflow")
def test_eval_3d_windows_through_the_sharded_runner(eval_data, monkeypatch):
    """``eval_3d``: the windows (``slice_bucket`` 8, rounded up to the data
    axis of 3: 9 slices) split over the data devices give the per-volume
    Dice of the one-device CLI with windows of 9."""
    tmp, paths, ckpt = eval_data
    runs = {}
    for tag, shape in (("one", None), ("three", {"data": 3})):
        if shape:
            monkeypatch.setattr(mesh, "local_devices", lambda device_type=None: [CPU] * 3)
        cfg = _cli_config(paths, str(tmp / f"e3d_{tag}"), ckpt, eval_3d=True, overlap_3d=2,
                          mesh_shape=shape, slice_bucket=9 if shape is None else 8)
        runs[tag] = _run_cli(torch_cli, tmp, f"e3d_{tag}", cfg, ["--platform", "cpu"])
    (a, la), (b, lb) = runs["one"], runs["three"]
    assert la == [] and lb == ["[mesh {'data': 3, 'model': 1} over 3 local devices]"]
    assert a["episodes"] == b["episodes"] > 0 and b["failed_episodes"] == 0
    for cls, ref in a["classes"].items():
        np.testing.assert_allclose(b["classes"][cls]["affine"], ref["affine"], atol=1e-4)
        np.testing.assert_allclose(b["classes"][cls]["fewshot"], ref["fewshot"], atol=1e-4)


# ---------------------------------------------------------------- LGCA

LGCA_CFG = {"init_lr": 1e-3, "scheduler_step": 0}
SGD = {"optimizer": "sgd", "init_lr": 1.0, "momentum": 0.9, "weight_decay": 0.0,
       "scheduler_step": 0}


@pytest.fixture(scope="module")
def lgca_case():
    """U_Net with BatchNorm2d, 8 slices of 32², its random JAX variables, and
    two JAX sharded Adam steps over {data: 4} → (variables, batch, JAX
    losses, JAX parameters as the port's state_dict, the JAX model)."""
    batch = inputs(seed=11, b=8)
    model = jl.LGCANetV3(output_ch=K, norm="BatchNorm2d", feature_scale=FS)
    variables = random_lgca_variables(model, *batch[:2], seed=4)
    opt = jax_make_optimizer(LGCA_CFG)
    state = {"step": np.int32(0), "params": variables["params"],
             "batch_stats": variables["batch_stats"], "opt_state": opt.init(variables["params"])}
    run = jax_sharded_lgca_train_step(model, LGCA_CFG, opt, jax_mesh_of({"data": 4}))
    losses = []
    for _ in range(2):
        state, metrics = run(state, batch)
        losses.append(float(metrics["loss"]))
    state = jax.tree_util.tree_map(np.asarray, state)
    trained = {"params": state["params"], "batch_stats": state["batch_stats"]}
    return variables, batch, losses, trained, model


def port_lgca(variables, dtype=torch.float32):
    port = tl.LGCANetV3(output_ch=K, norm="BatchNorm2d", feature_scale=FS)
    port.load_state_dict(lgca_state_dict_from_jax(variables), strict=True)
    return port.to(dtype)


def _lgca_steps(port, cfg, step_of, batch, n=2):
    optimizer = make_optimizer(port.parameters(), cfg)
    step, state = step_of(port, optimizer), {"step": 0}
    b = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(next(port.parameters()).dtype)
              for a in batch)
    return [float(step(state, b)["loss"]) for _ in range(n)]


def _per_shard_step(n_data):
    """The step of a data-parallel copy: each shard of the slice batch
    through the one-device forward, batch statistics per shard."""
    def make(model, optimizer):
        def forward(volume, slices):
            outs = [model(volume, s) for s in slices.chunk(n_data)]
            return {"seg_2d": torch.cat([o["seg_2d"] for o in outs]), "dsv": outs[0]["dsv"]}
        return _lgca_step(model, optimizer, forward)
    return make


def _state_close(a, b, rtol):
    """Every tensor of two state_dicts within ``rtol`` of its scale."""
    worst = 0.0
    for k, v in b.items():
        if v.is_floating_point():
            scale = max(float(v.abs().max()), 1e-9)
            worst = max(worst, float((a[k].detach() - v).abs().max()) / scale)
    assert worst <= rtol, worst
    return worst


def test_lgca_clis_on_two_devices(tmp_path, monkeypatch):
    """Both LGCA CLIs with ``mesh_shape: {data: 2}`` on two devices: the
    ``[LGCA mesh ...]`` lines the JAX CLIs print for the JAX resolver's mesh
    on two devices (the JAX sharded LGCA compile takes over a minute here;
    its step is held above), the epoch loss of the one-device train CLI
    (which ``test_torch_lgca_cli.py`` holds to the JAX CLI's), and the eval
    CLI's per-ROI Dice of the one-device eval CLI on that checkpoint."""
    paths, shared = lgca_cli.dataset_and_weights(tmp_path)
    two = jax.devices()[:2]
    jmesh = jax_mesh.resolve_local_mesh({"data": 2}, devices=two, batch_divisor=4)
    want = [f"[LGCA mesh {dict(jmesh.shape)} over {jmesh.devices.size} local devices]",
            f"[LGCA mesh {dict(jax_mesh.resolve_local_mesh({'data': 2}, devices=two).shape)} "
            f"over {len(two)} local devices]"]
    out = {}
    for tag, shape in (("one", None), ("two", {"data": 2})):
        if shape:
            monkeypatch.setattr(mesh, "local_devices", lambda device_type=None: [CPU] * 2)
        cfg = dict(lgca_cli._config(paths, str(tmp_path / f"train_{tag}"), shared),
                   mesh_shape=shape)
        trained = lgca_cli._run(torch_train_cli, tmp_path, f"train_{tag}", cfg,
                                ("--platform", "cpu"))
        ev = dict(cfg, ckpt=trained["checkpoint"], out_dir=str(tmp_path / f"eval_{tag}"))
        lgca_cli._run(torch_cli, tmp_path, f"eval_{tag}", ev, ("--platform", "cpu"))
        lines = []
        for log in (f"train_{tag}/log_train", f"eval_{tag}/log_eval"):
            with open(tmp_path / log) as f:
                lines += [l.strip() for l in f if l.startswith("[LGCA mesh")]
        out[tag] = (trained["epoch_losses"],
                    lgca_cli._lines(str(tmp_path / f"eval_{tag}" / "log_eval"), lgca_cli._VOLUME),
                    lines)
    assert out["one"][2] == [] and out["two"][2] == want
    np.testing.assert_allclose(out["two"][0], out["one"][0], rtol=1e-4)
    (one,), (two_,) = out["one"][1], out["two"][1]
    assert one[:2] == two_[:2] and one[4] == two_[4] == "None"   # Kidney L: no file
    np.testing.assert_allclose([float(v) for v in two_[2:4]], [float(v) for v in one[2:4]],
                               atol=1e-3)


def test_sharded_lgca_step_is_the_one_device_step_in_f64(lgca_case):
    variables, batch = lgca_case[:2]
    one, sharded = port_lgca(variables, torch.float64), port_lgca(variables, torch.float64)
    l1 = _lgca_steps(one, SGD, make_lgca_train_step, batch)
    l2 = _lgca_steps(sharded, SGD, lambda m, o: sharded_lgca_train_step(
        m, o, logical({"data": 4})), batch)
    np.testing.assert_allclose(l2, l1, rtol=1e-12)
    _state_close(sharded.state_dict(), one.state_dict(), 1e-9)


def test_sharded_lgca_step_matches_jax(lgca_case):
    variables, batch, jax_losses, trained = lgca_case[:4]
    one, sharded = port_lgca(variables), port_lgca(variables)
    l1 = _lgca_steps(one, LGCA_CFG, make_lgca_train_step, batch)
    l2 = _lgca_steps(sharded, LGCA_CFG, lambda m, o: sharded_lgca_train_step(
        m, o, logical({"data": 4})), batch)
    np.testing.assert_allclose(l2, l1, rtol=1e-3)
    np.testing.assert_allclose(l2, jax_losses, rtol=1e-3)
    ref = lgca_state_dict_from_jax(trained)
    own, single = sharded.state_dict(), one.state_dict()
    for n, _ in sharded.named_parameters():
        np.testing.assert_allclose(own[n].numpy(), ref[n].numpy(), atol=5e-3, err_msg=n)
        np.testing.assert_allclose(own[n].numpy(), single[n].numpy(), atol=5e-3, err_msg=n)


def test_batch_statistics_per_shard_break_the_lgca_step(lgca_case):
    """Why the sharded step's batch norms are global: a data-parallel copy
    whose batch norms see only their shard's 2 slices takes other gradients.
    After two f64 SGD steps at lr 1 (the parameter change is the gradient)
    some parameter is off the one-device step's by more than 5e-3 of its
    scale (the bound the sharded step is held to in f32; in f64 it keeps
    1e-9, ``test_sharded_lgca_step_is_the_one_device_step_in_f64``). The
    Dice loss of these random weights barely moves either way."""
    variables, batch = lgca_case[:2]
    one = port_lgca(variables, torch.float64)
    local = port_lgca(variables, torch.float64)
    _lgca_steps(one, SGD, make_lgca_train_step, batch)
    _lgca_steps(local, SGD, _per_shard_step(4), batch)
    params = dict(one.named_parameters())
    with pytest.raises(AssertionError):
        _state_close({n: p for n, p in local.named_parameters()},
                     {n: p.detach() for n, p in params.items()}, 5e-3)


def test_sharded_lgca_eval_matches(lgca_case):
    _, batch, _, trained, model = lgca_case
    rng = np.random.RandomState(2)
    sample = {"volume": batch[0], "slices": rng.randn(13, H, H, 1).astype(np.float32),
              "mask": (rng.rand(13, H, H, K) > 0.6).astype(np.float32)}
    sample["mask"][..., 1] = 0                 # an empty class: None in every eval
    want = jax_evaluate_lgca_volume(model, trained, sample, chunk=8,
                                    mesh=jax_mesh_of({"data": 4}))
    port = port_lgca(trained).eval()
    one = evaluate_lgca_volume(port, sample, "cpu", chunk=8)
    got = evaluate_lgca_volume(port, sample, "cpu", chunk=8, mesh=logical({"data": 3}))
    assert want["class_1"] is None and got["class_1"] is None and one["class_1"] is None
    np.testing.assert_allclose(got["class_0"], one["class_0"], atol=1e-3)
    np.testing.assert_allclose(got["class_0"], want["class_0"], atol=1e-3)


# ---------------------------------------------------------------- RP_Net training

TRAIN_CFG = dict(n_way=1, n_shot=1, k=2, crop_size=[H, H], n_iter_refinement=T,
                 mask_refinement_correlation_radius=R, use_registration_loss=False,
                 reg_affine_iters=2, reg_fit_scale=1, reg_sampler="gather",
                 loss="dice_ce", align_loss_scaler=1.0, weight_decay=1e-4,
                 scheduler_step=0, compute_dtype=None, init_lr=1e-4)


def _train_batch(E=4, k=2, seed=0):
    """E episodes of k smooth 32² slices with a shifted elliptic organ."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:H, :H] / H
    out = [[], [], [], []]
    for _ in range(E * k):
        cy, cx, dy, dx = rng.uniform(0.4, 0.6, 2).tolist() + rng.uniform(-0.06, 0.06, 2).tolist()
        for i, (oy, ox) in ((0, (cy, cx)), (2, (cy + dy, cx + dx))):
            r2 = ((yy - oy) / 0.22) ** 2 + ((xx - ox) / 0.28) ** 2
            out[i + 1].append((r2 <= 1).astype(np.float32))
            out[i].append((0.8 * np.exp(-r2) - 0.4 + 0.01 * rng.randn(H, H)).astype(np.float32))
    s = (E, 1, k, H, H)
    return (np.stack(out[0]).reshape(s), np.stack(out[1]).reshape(s),
            np.stack(out[2]).reshape((E, k, H, H)), np.stack(out[3]).reshape((E, k, H, H)))


def test_sharded_train_step_is_the_one_device_step_in_f64(rpnet_weights):
    """dp × tp, {data: 4, model: 2}, with the registration prior: the loss,
    every parameter (its change is the gradient at lr 1) and every running
    statistic of the one-device step; the split weights' optimizer entries
    are their rows."""
    cfg = dict(TRAIN_CFG, use_registration_loss=True, optimizer="sgd", init_lr=1.0,
               momentum=0.9, weight_decay=0.0)
    batch = tuple(torch.from_numpy(a.astype(np.float64)) for a in _train_batch())
    one = port_rpnet(rpnet_weights, train=True).double()
    sharded = port_rpnet(rpnet_weights, train=True).double()
    opt1 = make_optimizer(one.parameters(), cfg)
    opt2 = make_optimizer(sharded.parameters(), cfg)
    step1 = make_train_step(one, cfg, opt1)
    step2 = sharded_train_step(sharded, cfg, opt2, logical({"data": 4, "model": 2}))
    s1, s2 = {"step": 0}, {"step": 0}
    m1, m2 = step1(s1, batch), step2(s2, batch)
    for k in ("loss", "seg_loss", "align_loss"):
        np.testing.assert_allclose(float(m2[k]), float(m1[k]), rtol=1e-10)
    assert s2["step"] == 1
    _state_close(sharded.state_dict(), one.state_dict(), 1e-9)
    entries = [p for g in opt2.param_groups for p in g["params"]]
    assert len(entries) == len(list(sharded.parameters())) + 14   # 14 weights, 2 rows each
    split = [p for p in entries if all(p is not q for q in sharded.parameters())]
    assert len(split) == 28 and all(p.shape[0] * 2 >= 256 for p in split)
    assert all(opt2.state[p]["momentum_buffer"].shape == p.shape for p in split)


def test_sharded_train_step_matches_jax(rpnet_weights):
    batch = _train_batch(seed=1)
    model = JaxRPNet(backbone="UNet", num_iter=T, radius=R, align=True, soft_mask=True)
    opt = jax_make_optimizer(TRAIN_CFG)
    v = rpnet_weights
    state = {"step": np.int32(0), "params": v["params"], "batch_stats": v["batch_stats"],
             "opt_state": opt.init(v["params"])}
    run = jax_sharded_train_step(model, TRAIN_CFG, opt, jax_mesh_of({"data": 4, "model": 2}))
    _, jm = run(state, tuple(jnp.asarray(a) for a in batch))
    port = port_rpnet(v, train=True)
    step = sharded_train_step(port, TRAIN_CFG, make_optimizer(port.parameters(), TRAIN_CFG),
                              logical({"data": 4, "model": 2}))
    pm = step({"step": 0}, tuple(torch.from_numpy(a) for a in batch))
    assert float(pm["loss"]) == pytest.approx(float(jm["loss"]), abs=1e-4)
