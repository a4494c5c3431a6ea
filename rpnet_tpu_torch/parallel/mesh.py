"""Multi-process runtime, the per-process mesh and in-process sharding.

The counterpart of ``rpnet_tpu/parallel/mesh.py``:

  * :func:`maybe_initialize_distributed` joins a process group when the YAML
    asks for it (``multihost: true``) or when launched by torchrun
    (``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``). The group is
    ``gloo``: what crosses processes are the eval CLIs' host record
    arrays, and NCCL refuses two ranks on one card;
  * :func:`allgather_merge_records` merges the per-episode records of the
    eval CLIs' strided shards on every process;
  * :func:`make_mesh` / :func:`resolve_local_mesh` resolve ``mesh_shape``
    for one process's local devices with the JAX module's policies and
    error messages, into a :class:`LocalMesh`: a ``data`` × ``model`` grid
    of ``torch.device`` objects;
  * :func:`replicated`, :func:`shard_slices` and :func:`gather_slices` are
    the layouts (the JAX module's ``replicated`` and ``shard_slices``
    shardings): a tensor copied to every data device, an axis split over
    the data devices and gathered back to the first device;
  * :func:`param_sharding_rule` / :func:`shard_params` are the
    tensor-parallel rule: a conv weight (OIHW) with at least 256 output
    channels, divisible by the ``model`` axis, is split over it.

A single process's local devices are every card of its host, as
``jax.local_devices()`` gives every chip; a process of a group has one card.
One process shards over its devices in process, with one host thread
enqueueing each device's work in turn (launches are asynchronous, so
distinct cards overlap): ``episode/pipeline.EpisodeRunner(mesh=...)``
splits an eval episode's query slices over ``data``,
``train/lgca.sharded_lgca_train_step`` and ``evaluate_lgca_volume(mesh=...)``
the LGCA slice batch, ``train/trainer.sharded_train_step`` the RP_Net
training episodes (``data``) and the wide convs' output channels
(``model``). :func:`make_mesh` also takes a list that repeats a device
(``[cpu] * 8``, ``[cuda:0] * 2``): logical devices, which run the same code
path on one device (the counterpart of the JAX tests' 8 virtual CPU
devices). :func:`local_devices` and the CLIs' resolver report real devices
only.
"""

from __future__ import annotations

import copy
import dataclasses
import datetime
import os
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

# seconds a process waits for the others, at the group's init and in every
# collective, before it raises
INIT_TIMEOUT_S = 300.0

_TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def _group_up() -> bool:
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def maybe_initialize_distributed(config=None) -> bool:
    """Join the process group when ``multihost: true`` is in the YAML or the
    process was launched by torchrun; a no-op otherwise. Returns True if a
    group is up (also when it already was).

    The YAML keys ``coordinator_address`` (``host:port``, where process 0
    listens), ``num_processes`` and ``process_id`` give the group's address,
    world size and rank; torchrun's variables fill what they leave out. An
    explicit request whose init fails raises ``RuntimeError`` (N processes
    silently running N whole evals would print N uncoordinated results);
    ``RPNET_MULTIHOST_OPTIONAL=1`` turns that into a printed skip."""
    want = bool(config.get("multihost")) if config is not None else False
    torchrun = all(os.environ.get(k) for k in _TORCHRUN_VARS)
    if not (want or torchrun):
        return False
    if _group_up():
        return True
    cfg = config if config is not None else {}
    addr = cfg.get("coordinator_address")
    world = cfg.get("num_processes")
    rank = cfg.get("process_id")
    if addr is None and torchrun:
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if world is None and os.environ.get("WORLD_SIZE"):
        world = int(os.environ["WORLD_SIZE"])
    if rank is None and os.environ.get("RANK"):
        rank = int(os.environ["RANK"])
    try:
        if addr is None or world is None or rank is None:
            raise ValueError(f"coordinator_address {addr!r}, num_processes {world!r} and "
                             f"process_id {rank!r} must all be set")
        torch.distributed.init_process_group(
            "gloo", init_method=f"tcp://{addr}", world_size=int(world), rank=int(rank),
            timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
        return True
    except Exception as e:
        optional = os.environ.get("RPNET_MULTIHOST_OPTIONAL", "").lower()
        if optional not in ("", "0", "false", "no"):
            print(f"[multihost init skipped: {e}]")
            return False
        raise RuntimeError(
            f"multihost init requested ({'multihost: true' if want else 'torchrun variables'}) "
            f"but torch.distributed.init_process_group failed: {e}") from e


def process_count() -> int:
    """The group's world size; 1 when no group is up."""
    return torch.distributed.get_world_size() if _group_up() else 1


def process_index() -> int:
    """This process's rank; 0 when no group is up."""
    return torch.distributed.get_rank() if _group_up() else 0


def shard_indices(n: int, count: Optional[int] = None,
                  index: Optional[int] = None) -> List[int]:
    """The strided shard of ``range(n)`` this process owns
    (``rpnet_tpu/cli/test_rpnet.py:115-117``): every ``count``-th item from
    ``index``; all of them for one process."""
    count = process_count() if count is None else count
    index = process_index() if index is None else index
    return list(range(index, n, count)) if count > 1 else list(range(n))


def allgather_merge_records(arrays: Sequence[np.ndarray], failures: int = 0):
    """Merge per-episode record arrays and a failure count across processes.

    Each process fills only its own slots: integer arrays hold -1 elsewhere,
    float arrays NaN. Every process gets the full record: integer arrays
    merged by ``max``, float arrays by ``nanmax``; the failures summed. A
    single process gets its inputs back unchanged."""
    if process_count() <= 1:
        return list(arrays), failures
    dist = torch.distributed
    n = process_count()

    def gather(a: np.ndarray) -> np.ndarray:
        t = torch.from_numpy(np.ascontiguousarray(a))
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t)
        return torch.stack(parts).numpy()             # (P, ...)

    def merge(a: np.ndarray) -> np.ndarray:
        g = gather(a)
        if np.issubdtype(a.dtype, np.integer):
            return g.max(axis=0)          # -1 everywhere except the owner
        with warnings.catch_warnings():   # a slot nobody filled stays NaN
            warnings.simplefilter("ignore", RuntimeWarning)
            return np.nanmax(g, axis=0)   # at most one non-NaN per slot

    merged = [merge(np.asarray(a)) for a in arrays]
    total_failures = int(gather(np.asarray([failures], np.int64)).sum())
    return merged, total_failures


@dataclasses.dataclass
class LocalMesh:
    """A resolved mesh: its ``{"data", "model"}`` shape and its devices,
    data-major (row ``i`` of the grid is ``devices[i * model:(i + 1) *
    model]``). A device may repeat (logical devices)."""
    shape: Dict[str, int]
    devices: List

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def rows(self) -> List[List]:
        """The grid: one list of ``model`` devices per data index."""
        m = self.shape["model"]
        return [self.devices[i * m:(i + 1) * m] for i in range(self.shape["data"])]

    @property
    def data_devices(self) -> List:
        """The first device of each row: where a data shard runs."""
        return [row[0] for row in self.rows]

    @property
    def first(self):
        """The mesh's first device: where the master parameters and the
        gathered outputs live."""
        return self.devices[0]


def local_devices(device_type: Optional[str] = None) -> List[torch.device]:
    """This process's devices. On the card: every visible card for a single
    process (as ``jax.local_devices()`` gives every local chip), one card
    a process in a group, ``cuda:(rank % cards)`` (``cuda:0`` for every
    process on one card). On the CPU ``[cpu]``. By default the card where
    there is one."""
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if torch.device(device_type).type == "cuda":
        cards = torch.cuda.device_count()
        if process_count() == 1:
            return [torch.device("cuda", i) for i in range(cards)]
        return [torch.device("cuda", process_index() % cards)]
    return [torch.device("cpu")]


def make_mesh(shape: Optional[Dict[str, int]] = None, devices=None) -> LocalMesh:
    """A mesh of ``devices``; by default all of them on the ``data`` axis."""
    devices = list(devices) if devices is not None else local_devices()
    if not shape:
        shape = {"data": len(devices), "model": 1}
    if "model" not in shape:
        shape = dict(shape, model=1)
    total = int(np.prod(list(shape.values())))
    if total != len(devices):
        raise ValueError(f"mesh shape {shape} needs {total} devices, "
                         f"have {len(devices)}")
    return LocalMesh({"data": int(shape["data"]), "model": int(shape["model"])}, devices)


def resolve_local_mesh(mesh_shape: Optional[Dict[str, int]], devices=None,
                       batch_divisor: Optional[int] = None, label: str = "mesh",
                       n_processes: Optional[int] = None) -> LocalMesh:
    """The per-process mesh of a CLI (RP_Net eval, LGCA train and eval),
    with the JAX resolver's policies and messages:

    * a ``mesh_shape`` sized for all processes' devices (the natural way to
      write the YAML) is taken per process: the data axis is divided by the
      process count when that lands on the local device count; anything
      else that does not fit the local devices raises;
    * ``batch_divisor`` (the LGCA slice batch) constrains the data axis: the
      automatic mesh takes the largest divisor of it that fits the devices;
      an explicit shape that does not divide it raises;
    * an explicit shape smaller than the local device count takes the first
      devices.

    ``n_processes`` stands for :func:`process_count` (tests reach the
    multi-process branch in one process with it)."""
    local = list(devices) if devices is not None else local_devices()
    shape = dict(mesh_shape) if mesh_shape else None
    if shape is not None:
        pcount = process_count() if n_processes is None else n_processes
        if pcount > 1:
            total = int(np.prod(list(shape.values())))
            data = int(shape.get("data", 1))
            if (total != len(local) and data % pcount == 0
                    and total // pcount == len(local)):
                shape["data"] = data // pcount
                print(f"[{label}_shape data axis {data} split over {pcount} "
                      f"processes → {shape['data']} local]")
            elif total != len(local):
                raise ValueError(
                    f"mesh_shape {dict(mesh_shape)} needs {total} devices but "
                    f"meshes span only this process's {len(local)} local "
                    f"devices (work shards across processes); use a "
                    f"per-process shape or a data axis divisible by "
                    f"process_count={pcount}")
        if (batch_divisor is not None
                and batch_divisor % int(shape.get("data", 1)) != 0):
            raise ValueError(
                f"mesh_shape data axis {shape.get('data')} must divide the "
                f"sharded batch size {batch_divisor}")
        total = int(np.prod(list(shape.values())))
        if total < len(local):
            local = local[:total]
        return make_mesh(shape, devices=local)
    if batch_divisor is not None:
        data = max(d for d in range(1, len(local) + 1) if batch_divisor % d == 0)
        return make_mesh({"data": data, "model": 1}, devices=local[:data])
    return make_mesh(None, devices=local)


def resolve_cli_mesh(mesh_shape, device, batch_divisor: Optional[int] = None,
                        prefix: str = "") -> Optional[LocalMesh]:
    """A CLI's mesh as the JAX CLIs resolve it (``rpnet_tpu/cli/
    test_rpnet.py:76-83, 348-355``, ``cli/train.py:113-123``): where
    ``mesh_shape`` is set or the process has more than one local device of
    ``device``'s type, resolved and printed (``[{prefix}mesh {shape} over N
    local devices]``); None otherwise."""
    local = local_devices(torch.device(device).type)
    if not (mesh_shape or len(local) > 1):
        return None
    mesh = resolve_local_mesh(mesh_shape, devices=local, batch_divisor=batch_divisor)
    n = mesh.size if batch_divisor is not None else len(local)
    print(f"[{prefix}mesh {mesh.shape} over {n} local devices]")
    return mesh


# --------------------------------------------------------------------------
# layouts and the tensor-parallel rule
# --------------------------------------------------------------------------

def replicated(mesh: LocalMesh, tensor: torch.Tensor) -> List[torch.Tensor]:
    """``tensor`` on each data device, one copy per distinct device (logical
    devices that repeat a device share it); copies do not block the host."""
    copies: Dict = {}
    return [copies.setdefault(d, tensor.to(d, non_blocking=True))
            for d in mesh.data_devices]


def shard_slices(mesh: LocalMesh, tensor: torch.Tensor, axis: int = 0) -> List[torch.Tensor]:
    """``tensor`` split along ``axis`` over the data devices, in order: the
    first ``n % data`` shards one longer (``torch.tensor_split``); a device
    whose shard is empty gets none. A shard already on its device is a view."""
    parts = torch.tensor_split(tensor, mesh.shape["data"], dim=axis)
    return [p.to(d, non_blocking=True) for p, d in zip(parts, mesh.data_devices)
            if p.shape[axis]]


def gather_slices(parts: Sequence[torch.Tensor], device, axis: int = 0) -> torch.Tensor:
    """The shards of :func:`shard_slices` concatenated on ``device``."""
    return torch.cat([p.to(device, non_blocking=True) for p in parts], dim=axis)


def module_replicas(module: torch.nn.Module, devices) -> Dict[torch.device, torch.nn.Module]:
    """``module`` on each distinct device of ``devices``: the module itself
    on the device it lives on, a copy elsewhere (made once; the caller
    re-makes them after the weights change)."""
    home = next(module.parameters()).device
    out: Dict[torch.device, torch.nn.Module] = {}
    for d in map(torch.device, devices):
        if d not in out:
            out[d] = module if d == home else copy.deepcopy(module).to(d)
    return out


def param_sharding_rule(name: str, tensor: torch.Tensor, mesh: LocalMesh,
                        min_channels: int = 256) -> str:
    """``"model"`` where the tensor-parallel rule splits ``name`` over the
    ``model`` axis, else ``"replicated"``: a conv weight (OIHW) whose output
    channels are at least ``min_channels`` and divisible by the axis, as
    ``rpnet_tpu/parallel/mesh.py:188-205`` picks HWIO kernels by their
    last axis. Biases and norm parameters stay replicated."""
    n_model = mesh.shape.get("model", 1)
    shape = tuple(tensor.shape)
    if (n_model > 1 and name.endswith("weight") and len(shape) == 4
            and shape[0] >= min_channels and shape[0] % n_model == 0):
        return "model"
    return "replicated"


def shard_params(model: torch.nn.Module, mesh: LocalMesh,
                 min_channels: int = 256) -> Dict[str, str]:
    """The rule's placement of every ``state_dict`` entry of ``model``."""
    return {name: param_sharding_rule(name, t, mesh, min_channels)
            for name, t in model.state_dict().items()}
