"""rpnet_tpu_torch/parallel/mesh.py against rpnet_tpu/parallel/mesh.py, and
the CLIs' mesh branches.

  * the resolver over a grid of ``mesh_shape`` × local device counts ×
    ``batch_divisor`` × process counts: the JAX ``resolve_local_mesh`` on the
    first n of the suite's 8 virtual CPU devices (``jax.process_count``
    patched), the port's on n placeholder devices (its process count passed
    in): the same shape, the same devices and the same printed line, or the
    same error message;
  * the strided per-process split of the eval CLIs;
  * the record merge on hand-made shards (-1 and NaN slots, failures
    summed), both packages' merges over one faked all-gather;
  * ``maybe_initialize_distributed``: a no-op without a trigger, fatal on an
    explicit request to a coordinator nobody serves (a short timeout), a
    printed skip under ``RPNET_MULTIHOST_OPTIONAL=1``;
  * the CLIs: RP_Net eval with ``{data: 8}`` raises the JAX resolver's
    message; LGCANet_V3 with ``{data: 1}`` trains and evaluates;
  * a 2-device logical mesh runs an episode, and a single process on four
    cards resolves its mesh over them.

The two-process eval over a real gloo group is ``test_torch_multiprocess.py``;
the in-process sharded paths against the JAX package are
``test_torch_sharding.py``.
"""

import socket
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from rpnet_tpu.core.synthetic import generate_dataset
from rpnet_tpu.parallel import mesh as jax_mesh
from rpnet_tpu_torch.cli import test_rpnet as torch_eval_cli
from rpnet_tpu_torch.cli import train as torch_train_cli
from rpnet_tpu_torch.parallel import mesh

torch.set_num_threads(2)   # small shapes; the suite runs several workers on one machine

SHAPES = (None, {"data": 1}, {"data": 4, "model": 2}, {"data": 8}, {"data": 3})


def _resolve(fn, *args, **kw):
    """(shape, device indices, printed lines) or the error's text."""
    try:
        m, printed = fn(*args, **kw)
    except ValueError as e:
        return f"ValueError: {e}"
    return m, printed


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_resolver_matches_jax(shape, n_devices, monkeypatch, capsys):
    devices = jax.devices()[:n_devices]
    placeholders = [f"device{i}" for i in range(n_devices)]
    for n_processes in (1, 2):
        monkeypatch.setattr(jax, "process_count", lambda: n_processes)
        for batch_divisor in (None, 4, 13):
            def run_jax():
                m = jax_mesh.resolve_local_mesh(shape, devices=devices,
                                                batch_divisor=batch_divisor)
                used = [devices.index(d) for d in m.devices.ravel().tolist()]
                return (dict(m.shape), used), capsys.readouterr().out

            def run_port():
                m = mesh.resolve_local_mesh(shape, devices=placeholders,
                                            batch_divisor=batch_divisor,
                                            n_processes=n_processes)
                used = [placeholders.index(d) for d in m.devices]
                return (m.shape, used), capsys.readouterr().out

            want, got = _resolve(run_jax), _resolve(run_port)
            assert got == want, (shape, n_devices, n_processes, batch_divisor)


@pytest.mark.parametrize("n", [0, 1, 3, 7])
def test_shard_indices(n):
    for count in (1, 2, 3):
        shards = [mesh.shard_indices(n, count, index) for index in range(count)]
        # rpnet_tpu/cli/test_rpnet.py:115-117
        assert shards == [list(range(index, n, count)) if count > 1 else list(range(n))
                          for index in range(count)]
        assert sorted(sum(shards, [])) == list(range(n))
    assert mesh.shard_indices(n) == list(range(n))   # no group: one process


def _shards():
    """Two processes' records of 3 episodes: process 0 owns 0 and 2 (episode 2
    failed), process 1 owns 1 (an empty ground truth: NaN Dice)."""
    cls = [np.array([0, -1, -1], np.int32), np.array([-1, 0, -1], np.int32)]
    aff = [np.array([0.5, np.nan, np.nan]), np.array([np.nan, np.nan, np.nan])]
    ref = [np.array([[0.1, 0.2], [np.nan] * 2, [np.nan] * 2]),
           np.array([[np.nan] * 2, [0.3, np.nan], [np.nan] * 2])]
    return [(cls[p], aff[p], ref[p]) for p in range(2)], [1, 0]


def test_merge_records_matches_jax(monkeypatch):
    from jax.experimental import multihost_utils

    records, failures = _shards()
    others = []

    def fake_gather(parts, t):          # this process is rank 0
        parts[0].copy_(t)
        parts[1].copy_(torch.from_numpy(others.pop(0)))

    monkeypatch.setattr(mesh, "process_count", lambda: 2)
    monkeypatch.setattr(torch.distributed, "all_gather", fake_gather)
    others[:] = [*records[1], np.asarray([failures[1]], np.int64)]
    merged, total = mesh.allgather_merge_records(records[0], failures[0])
    assert not others

    monkeypatch.setattr(jax, "process_count", lambda: 2)
    jax_others = [*records[1], np.asarray(failures[1])]
    monkeypatch.setattr(multihost_utils, "process_allgather",
                        lambda a: np.stack([np.asarray(a), jax_others.pop(0)]))
    want, want_total = jax_mesh.allgather_merge_records(records[0], failures[0])
    assert total == want_total == 1
    for a, b in zip(merged, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    np.testing.assert_array_equal(merged[0], [0, 0, -1])
    np.testing.assert_array_equal(merged[2], [[0.1, 0.2], [0.3, np.nan], [np.nan] * 2])
    # one process: its own records back, unchanged
    monkeypatch.undo()
    same, n_failed = mesh.allgather_merge_records(records[0], 3)
    assert n_failed == 3 and all(a is b for a, b in zip(same, records[0]))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def no_torchrun(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "RPNET_MULTIHOST_OPTIONAL"):
        monkeypatch.delenv(k, raising=False)


@pytest.mark.usefixtures("no_torchrun")
def test_initialize_is_a_no_op_without_a_trigger():
    assert mesh.maybe_initialize_distributed({}) is False
    assert mesh.maybe_initialize_distributed({"multihost": False}) is False
    assert mesh.maybe_initialize_distributed(None) is False
    assert not torch.distributed.is_initialized()
    assert (mesh.process_count(), mesh.process_index()) == (1, 0)


@pytest.mark.usefixtures("no_torchrun")
@pytest.mark.parametrize("trigger", ["yaml", "torchrun"])
def test_explicit_request_to_an_unreachable_coordinator(trigger, monkeypatch, capsys):
    """Rank 1 of 2 waits for a coordinator (rank 0's store) that nobody
    serves: fatal, or a printed skip under RPNET_MULTIHOST_OPTIONAL=1."""
    monkeypatch.setattr(mesh, "INIT_TIMEOUT_S", 0.5)
    port = _free_port()
    if trigger == "yaml":
        config = {"multihost": True, "coordinator_address": f"127.0.0.1:{port}",
                  "num_processes": 2, "process_id": 1}
    else:
        config = {}
        for k, v in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(port)),
                     ("RANK", "1"), ("WORLD_SIZE", "2")):
            monkeypatch.setenv(k, v)
    what = "multihost: true" if trigger == "yaml" else "torchrun variables"
    with pytest.raises(RuntimeError, match=f"multihost init requested \\({what}\\)"):
        mesh.maybe_initialize_distributed(config)
    monkeypatch.setenv("RPNET_MULTIHOST_OPTIONAL", "1")
    assert mesh.maybe_initialize_distributed(config) is False
    assert "[multihost init skipped:" in capsys.readouterr().out
    assert not torch.distributed.is_initialized()


def _run(cli, tmp_path, name, cfg, extra=("--platform", "cpu")):
    ypath = str(tmp_path / f"{name}.yml")
    with open(ypath, "w") as f:
        yaml.safe_dump(cfg, f)
    stdout = sys.stdout
    try:
        return cli.main(["--yaml", ypath, *extra])
    finally:
        sys.stdout = stdout


def test_rpnet_eval_cli_refuses_a_mesh_it_cannot_hold(tmp_path):
    with pytest.raises(ValueError) as jax_err:
        jax_mesh.resolve_local_mesh({"data": 8}, devices=jax.devices()[:1])
    paths = generate_dataset(str(tmp_path / "data"), n_train=1, n_test=2,
                             shape=(16, 48, 48), seed=0)
    cfg = dict(data_dir=paths["data_dir"], class_csv_dir=paths["class_dir"],
               eval_set_name=paths["test_csv"], num_slice=16, num_x=48, num_y=48,
               crop_size=[32, 32], k=2, eval_classes=["Liver"],
               n_iter_refinement=1, n_test_iter_refinement=1,
               mask_refinement_correlation_radius=1, reg_affine_iters=2,
               mesh_shape={"data": 8}, out_dir=str(tmp_path / "out"), n_runs=1)
    with pytest.raises(ValueError) as err:
        _run(torch_eval_cli, tmp_path, "rpnet", cfg)
    assert str(err.value) == str(jax_err.value) == (
        "mesh shape {'data': 8, 'model': 1} needs 8 devices, have 1")


def test_lgca_runs_on_a_one_device_mesh(tmp_path, capsys):
    """``{data: 1}``: the train CLI takes its 4-slice steps and the eval CLI
    its volume, each printing the resolved mesh as the JAX CLIs do."""
    paths = generate_dataset(str(tmp_path / "data"), n_train=1, n_test=1,
                             shape=(16, 32, 32), seed=0)
    cfg = dict(data_dir=paths["data_dir"], train_set_name=paths["train_csv"],
               eval_set_name=paths["test_csv"], num_slice=16, num_x=32, num_y=32,
               net="LGCANet_V3", roi_names=["Liver", "Spleen"], lgca_slices=4,
               feature_scale=8, epochs=1, n_runs=1, mesh_shape={"data": 1},
               out_dir=str(tmp_path / "out"))
    trained = _run(torch_train_cli, tmp_path, "train", cfg)
    assert len(trained["step_losses"]) == 1 and np.isfinite(trained["step_losses"]).all()
    out = capsys.readouterr().out
    assert "[LGCA mesh {'data': 1, 'model': 1} over 1 local devices]" in out
    results = _run(torch_eval_cli, tmp_path, "eval",
                   dict(cfg, ckpt=trained["checkpoint"]))
    assert results["volumes"] == 1 and results["failed_volumes"] == 0
    assert "[LGCA mesh {'data': 1, 'model': 1} over 1 local devices]" in capsys.readouterr().out


def test_more_than_one_device_is_not_ported():
    """Once a refusal, now the path: a mesh of two logical CPU devices runs
    an episode, split over both (each shard launches its own work), with
    the one-device runner's metrics; the real local devices are still one
    CPU."""
    from rpnet_tpu_torch.episode.pipeline import EpisodeRunner
    from rpnet_tpu_torch.episode.sampler import Episode
    from rpnet_tpu_torch.models.factory import build_rpnet

    cfg = {"backbone": "UNet", "crop_size": [16, 16], "k": 2, "n_iter_refinement": 1,
           "mask_refinement_correlation_radius": 1, "reg_affine_iters": 2,
           "compute_dtype": "float32", "slice_bucket": 3, "max_slices": 5}
    rng = np.random.RandomState(0)
    lab = (rng.rand(1, 5, 16, 16) > 0.6).astype(np.float32)
    ep = Episode(support_images=rng.uniform(-1, 1, (1, 5, 16, 16)).astype(np.float32),
                 support_labels=lab, query_images=rng.uniform(-1, 1, (5, 16, 16)).astype(np.float32),
                 query_labels=lab[0], class_id=0, pid="p", supp_pids=[(0, 0)])
    two = mesh.make_mesh({"data": 2}, devices=[torch.device("cpu")] * 2)
    assert two.data_devices == [torch.device("cpu")] * 2 and two.size == 2
    sharded = EpisodeRunner(build_rpnet(cfg, num_iter=1), cfg, "cpu", mesh=two)
    assert (sharded.bucket, sharded.max_slices) == (4, 6)   # rounded up to the data axis
    assert sharded._bounds(5) == [(0, 3), (3, 5)]
    want = EpisodeRunner(build_rpnet(cfg, num_iter=1), cfg, "cpu").run(ep)
    got = sharded.run(ep)
    assert got == want
    assert mesh.local_devices("cpu") == mesh.local_devices() == [torch.device("cpu")]
    assert mesh.resolve_local_mesh(None).shape == {"data": 1, "model": 1}


@pytest.fixture
def four_cards(monkeypatch):
    """A host with four cards, as torch.cuda reports it (nothing launches)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)


@pytest.mark.usefixtures("four_cards")
def test_local_devices_on_a_host_with_several_cards(monkeypatch):
    """A single process sees every card, as ``jax.local_devices()`` gives
    every local chip; a process of a group has ``cuda:(rank % cards)``."""
    cards = [torch.device("cuda", i) for i in range(4)]
    assert mesh.local_devices() == mesh.local_devices("cuda") == cards
    monkeypatch.setattr(mesh, "process_count", lambda: 8)
    monkeypatch.setattr(mesh, "process_index", lambda: 5)
    assert mesh.local_devices() == [torch.device("cuda", 1)]


@pytest.mark.usefixtures("four_cards")
def test_cli_mesh_on_a_host_with_several_cards(capsys):
    """One process on four cards resolves its mesh as the JAX CLI does on
    four chips: with no ``mesh_shape`` (the automatic mesh over every card)
    or ``{data: 4}`` or ``{data: 2, model: 2}`` the mesh spans the four
    cards, data-major; ``{data: 1}`` runs on the first card; ``{data: 8}``
    raises the JAX resolver's message."""
    jax_four = jax.devices()[:4]
    cards = [torch.device("cuda", i) for i in range(4)]
    for shape in (None, {"data": 4}, {"data": 2, "model": 2}):
        got = mesh.resolve_cli_mesh(shape, "cuda")
        jax_got = jax_mesh.resolve_local_mesh(shape, devices=jax_four)
        want = dict(jax_got.shape)
        assert f"[mesh {want} over 4 local devices]" in capsys.readouterr().out
        assert got.shape == want and got.devices == cards
        assert [[jax_four.index(d) for d in row] for row in jax_got.devices.tolist()] \
            == [[cards.index(d) for d in row] for row in got.rows]
        assert got.data_devices == [row[0] for row in got.rows]
    one = mesh.resolve_cli_mesh({"data": 1}, "cuda")
    assert one.devices == [torch.device("cuda", 0)] and one.shape == {"data": 1, "model": 1}
    assert "[mesh {'data': 1, 'model': 1} over 4 local devices]" in capsys.readouterr().out
    with pytest.raises(ValueError) as jax_err:
        jax_mesh.resolve_local_mesh({"data": 8}, devices=jax_four)
    with pytest.raises(ValueError) as err:
        mesh.resolve_cli_mesh({"data": 8}, "cuda")
    assert str(err.value) == str(jax_err.value)
    lgca = mesh.resolve_cli_mesh({"data": 1}, "cuda", batch_divisor=8, prefix="LGCA ")
    assert lgca.devices == [torch.device("cuda", 0)]
    assert "[LGCA mesh {'data': 1, 'model': 1} over 1 local devices]" in capsys.readouterr().out
    assert mesh.resolve_cli_mesh(None, "cpu") is None
