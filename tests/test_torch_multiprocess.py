"""The port's eval CLI as a two-process gloo group on the CPU, against one
process on the same YAML and against the JAX package's eval CLI.

``test_torch_cli.py``'s configuration: its data (3 synthetic test volumes
of 20×48×48), its shared ``.pth`` (a JAX RPNet's weights), f32 compute, 32²
crops, k=4, 2 refinement iterations, one prefetch worker. Three processes
start together: one alone, and two joined by ``multihost: true`` with
``mesh_shape: {data: 2}`` (the whole group's shape, which each process
resolves to ``{data: 1}``). Each runs the episodic eval on the spec path
and on the prefetch path, then ``eval_3d``, through
``rpnet_tpu_torch.cli.test_rpnet.main`` (one group serves all three). The
two processes print identical aggregate blocks, equal to the single run's;
the union of their episode (volume) lines is the single run's, line for
line, in shards of 2 and 1. The workers import no JAX. Meanwhile the parent
runs the JAX eval CLI once on the single YAML (``reg_sampler: gather``, the
fit the port's follows; the port's affine-only registration does not read
it): the merged episode lines and aggregate of both episodic paths match it,
every Dice within the 1e-3 of ``test_torch_cli.test_cli_parity``.
"""

import os
import re
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from rpnet_tpu.cli import test_rpnet as jax_cli
from rpnet_tpu.core.synthetic import generate_dataset
from rpnet_tpu_torch.train.convert import state_dict_from_jax

from test_torch_cli import _config
from test_torch_models import jax_rpnet, tensorboard_without_tensorflow  # noqa: F401

torch.set_num_threads(2)   # small shapes; the suite runs several workers on one machine

# the parent's JAX CLI run writes TensorBoard without TensorFlow
pytestmark = pytest.mark.usefixtures("tensorboard_without_tensorflow")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = ("import sys\n"
          "from rpnet_tpu_torch.cli import test_rpnet\n"
          "for y in sys.argv[1:]:\n"
          "    test_rpnet.main(['--yaml', y, '--platform', 'cpu'])\n")
HEADER = "=======Average performance========="
# the episodic eval on the spec path (the default device volume cache) and on
# the prefetch path (cache off, one worker thread), then eval_3d
MODES = {"spec": {}, "prefetch": {"device_volume_cache": 0},
         "eval_3d": {"eval_3d": True}}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: {mode: log lines}} for ``single``, ``p0`` and ``p1``."""
    tmp = tmp_path_factory.mktemp("multiprocess")
    paths = generate_dataset(str(tmp / "data"), n_train=3, n_test=3,
                             shape=(20, 48, 48), seed=0)
    _, variables = jax_rpnet(radius=2, num_iter=2, size=32, seed=3)
    ckpt = str(tmp / "shared.pth")
    torch.save({"epoch": 0, "state_dict": state_dict_from_jax(variables)}, ckpt)
    base = _config(paths, None, ckpt, overlap_3d=2, seed=0, num_workers=1,
                   reg_sampler="gather")
    coord = f"127.0.0.1:{_free_port()}"
    group = dict(multihost=True, coordinator_address=coord, num_processes=2,
                 mesh_shape={"data": 2})
    names = {"single": {}, "p0": dict(group, process_id=0), "p1": dict(group, process_id=1)}
    argv = {}
    for name, extra in names.items():
        argv[name] = []
        for mode, kw in MODES.items():
            path = str(tmp / f"{name}_{mode}.yml")
            with open(path, "w") as f:
                yaml.safe_dump(dict(base, out_dir=str(tmp / f"out_{name}_{mode}"),
                                    **extra, **kw), f)
            argv[name].append(path)
    with open(tmp / "jax_single.yml", "w") as f:
        yaml.safe_dump(dict(base, out_dir=str(tmp / "out_jax")), f)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="2", GLOO_SOCKET_IFNAME="lo")
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "RPNET_MULTIHOST_OPTIONAL"):
        env.pop(k, None)
    procs = {name: subprocess.Popen([sys.executable, "-c", WORKER, *argv[name]],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True, env=env, cwd=str(tmp))
             for name in names}
    outs = {}
    try:
        # the JAX CLI on the single episodic YAML, in the parent while the
        # workers run
        stdout = sys.stdout
        try:
            with pytest.MonkeyPatch.context() as mp:   # one device: no slice mesh
                one = jax.local_devices()[:1]
                mp.setattr(jax, "local_devices", lambda *a, **k: one)
                jax_cli.main(["--yaml", str(tmp / "jax_single.yml")])
        finally:
            sys.stdout = stdout   # the JAX CLI leaves its log tee installed
        for name, p in procs.items():
            outs[name], _ = p.communicate(timeout=240)
    finally:
        for p in procs.values():   # no orphaned worker holding the port
            if p.poll() is None:
                p.kill()
    for name, p in procs.items():
        assert p.returncode == 0, f"worker {name} failed:\n{outs[name]}"
    logs = {}
    for name in names:
        logs[name] = {}
        for mode in MODES:
            with open(tmp / f"out_{name}_{mode}" / "log_eval") as f:
                logs[name][mode] = f.read().splitlines()
    with open(tmp / "out_jax" / "log_eval") as f:
        logs["jax"] = f.read().splitlines()
    return logs


def _item_lines(lines):
    """Per-episode (per-volume) lines: ``<j> <pid> <supp_pid> affine ...``."""
    return [ln for ln in lines if ln and ln[0].isdigit() and " affine " in ln]


def _aggregate(lines):
    i = lines.index(HEADER)
    return lines[i:]


@pytest.mark.parametrize("mode", list(MODES))
def test_two_processes_give_the_single_run(runs, mode):
    single, p0, p1 = (runs[n][mode] for n in ("single", "p0", "p1"))
    assert _aggregate(p0) == _aggregate(p1) == _aggregate(single)
    assert sorted(_item_lines(p0) + _item_lines(p1)) == sorted(_item_lines(single))
    assert len(_item_lines(single)) == 3
    # the strided shards: items 0 and 2, then item 1
    assert [ln.split()[0] for ln in _item_lines(p0)] == ["0", "2"]
    assert [ln.split()[0] for ln in _item_lines(p1)] == ["1"]
    # each pass's per-class line is printed from the merged records too
    cls = [ln for ln in single if ln.startswith("Liver, ")][0]
    assert cls in p0 and cls in p1


def test_group_resolves_the_global_mesh_shape(runs):
    for name in ("p0", "p1"):
        lines = runs[name]["spec"]
        assert "[mesh_shape data axis 2 split over 2 processes → 1 local]" in lines
        assert "[mesh {'data': 1, 'model': 1} over 1 local devices]" in lines
    assert not any(ln.startswith("[mesh") for ln in runs["single"]["spec"])


_FLOAT = re.compile(r"-?\d+\.\d+(?:e-?\d+)?")


def _masked(lines):
    return [_FLOAT.sub("#", ln) for ln in lines]


def _floats(lines):
    return [float(x) for ln in lines for x in _FLOAT.findall(ln)]


@pytest.mark.parametrize("mode", ["spec", "prefetch"])
def test_two_processes_match_the_jax_cli(runs, mode):
    """The merged output of the two processes against the JAX eval CLI's
    single run: the same episode lines and aggregate block but for the last
    digits, each number within 1e-3."""
    jax_lines = runs["jax"]
    merged = sorted(_item_lines(runs["p0"][mode]) + _item_lines(runs["p1"][mode]),
                    key=lambda ln: int(ln.split()[0]))
    want = _item_lines(jax_lines)
    assert len(want) == 3 and _masked(merged) == _masked(want)
    np.testing.assert_allclose(_floats(merged), _floats(want), atol=1e-3)
    for name in ("p0", "p1"):
        got = _aggregate(runs[name][mode])
        assert _masked(got) == _masked(_aggregate(jax_lines))
        np.testing.assert_allclose(_floats(got), _floats(_aggregate(jax_lines)), atol=1e-3)
