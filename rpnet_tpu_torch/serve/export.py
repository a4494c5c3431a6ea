"""Export of the episode program for serving.

The counterpart of ``rpnet_tpu/serve/export.py``. The whole episode —
registration fit, network, refinement, metrics (``episode/pipeline.py``
``episode_metrics_fn``) — is captured by ``torch.export.export`` (non-strict)
into an ``ExportedProgram`` that a server reloads without the model's code.
The correlation is one node of the graph, a custom op of
``ops/correlation.py`` (``rpnet_torch::local_corr`` on the default route),
so the reloaded program launches the hand-written kernel on the card and
counts it as the live path does. So is the affine fit on the card
(``rpnet_torch::affine_fit``, ``registration/affine.py``); on the CPU the
fit's ``torch.autograd.grad`` is traced into the graph, whose backward
operators compute it. The ops are registered when
``rpnet_tpu_torch.ops.correlation`` and ``rpnet_tpu_torch.registration.affine``
are imported, which this module does.

Artifact layout (a directory):

  program.pt2    ``torch.export.save`` of the program
  manifest.json  shapes, dtypes, static configuration and provenance

Notes

* Weights are inputs, not constants: the program takes the model's
  floating-point ``state_dict`` tensors in f32 as a tuple (``weights`` in the
  manifest gives their names) and casts them to ``compute_dtype`` inside, so
  a ``.pth`` written after the export serves without exporting again.
* Shapes are static: ``slices`` query slices (the runner pads with
  ``slice_mask`` zero and truncates), one artifact a slice count, as in the
  JAX exporter.
* The device is part of the program: factory tensors (the zero-flow
  identity grid, the cached resize matrices) are recorded with the device they
  were made on, so :func:`load_artifact` refuses another device type.
* The correlation route is resolved while tracing
  (``ops.correlation.correlation_route``): an artifact serves the route it
  was exported with. The manifest records the ``RPNET_*`` variables then in
  force and the correlation ops in the graph; serving does not resolve the
  route again.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Any, Dict, Optional, Sequence

import torch

from rpnet_tpu_torch.ops.correlation import OP_NAMESPACE   # registers the custom ops
from rpnet_tpu_torch.registration import affine   # noqa: F401 — registers affine_fit

FORMAT_VERSION = 1
PROGRAM_FILE = "program.pt2"
MANIFEST_FILE = "manifest.json"
ROUTE_VARIABLES = ("RPNET_CORR_IMPL", "RPNET_ROT_EXTRACT", "RPNET_ROT_PACK")


def weight_names(model: torch.nn.Module):
    """The program's weight inputs: the model's floating-point ``state_dict``
    entries, in order (``num_batches_tracked`` is not read in eval)."""
    return [k for k, v in model.state_dict().items() if v.is_floating_point()]


class EpisodeProgram(torch.nn.Module):
    """``episode_metrics_fn`` with the weights as inputs:
    ``forward(weights, supp_img, supp_lab, qry_img, qry_lab, slice_mask)``
    → (packed metrics, last refinement's mask, prior)."""

    def __init__(self, model: torch.nn.Module, compute_dtype: torch.dtype, **fn_kwargs):
        super().__init__()
        # kept out of the module tree: its tensors are inputs, never state
        self.__dict__["net"] = model.eval()
        self.names = weight_names(model)
        self.compute_dtype = compute_dtype
        self.fn_kwargs = fn_kwargs

    def forward(self, weights, supp_img, supp_lab, qry_img, qry_lab, slice_mask):
        from rpnet_tpu_torch.episode.pipeline import episode_metrics_fn

        state = {n: w.to(self.compute_dtype) for n, w in zip(self.names, weights)}
        fn = episode_metrics_fn(
            lambda *a: torch.func.functional_call(self.net, state, a),
            compute_dtype=self.compute_dtype, **self.fn_kwargs)
        return fn(supp_img, supp_lab, qry_img, qry_lab, slice_mask)


def export_episode_program(model, *, slices: int, height: int, width: int,
                           shots: int = 1, affine_iters: int = 50,
                           demons_iters: int = 0, fit_scale: int = 4,
                           sampler: str = "matmul", multishot: bool = False,
                           n_way: int = 1, use_registration: bool = True,
                           reg_lr: float = 0.01, reg_sigma: float = 2.0,
                           compute_dtype=torch.bfloat16, device="cuda"):
    """Trace the episode program on ``device`` → ``torch.export.ExportedProgram``.

    ``model`` is read for its structure and its weights' shapes only; the
    program's inputs are ``(weights, supp_img (shots, slices, H, W),
    supp_lab, qry_img (slices, H, W), qry_lab, slice_mask (slices,))``, all
    f32."""
    device = torch.device(device)
    prog = EpisodeProgram(model, compute_dtype, affine_iters=affine_iters,
                          fit_scale=fit_scale, reg_lr=reg_lr, multishot=multishot,
                          use_registration=use_registration, n_way=n_way,
                          demons_iters=demons_iters, reg_sigma=reg_sigma,
                          reg_sampler=sampler)
    sd = model.state_dict()
    weights = tuple(sd[n].detach().float().to(device) for n in prog.names)
    f32 = dict(dtype=torch.float32, device=device)
    supp = torch.zeros((shots, slices, height, width), **f32)
    qry = torch.zeros((slices, height, width), **f32)
    args = (weights, supp, supp.clone(), qry, qry.clone(), torch.ones((slices,), **f32))
    exported = torch.export.export(prog, args, strict=False)
    exported.example_inputs = None   # else torch.export.save stores the weights
    return exported


def graph_nodes(exported):
    """Every node of the program, its subgraphs' included (the network runs
    under ``no_grad``, a subgraph of its own)."""
    for m in exported.graph_module.modules():
        if isinstance(m, torch.fx.GraphModule):
            yield from m.graph.nodes


def correlation_ops(exported) -> Dict[str, int]:
    """The correlation custom-op nodes (``rpnet_torch::local_corr*``) of the
    program, counted by op."""
    counts: Dict[str, int] = {}
    for node in graph_nodes(exported):
        name = str(node.target) if node.op == "call_function" else ""
        if name.startswith(OP_NAMESPACE + ".local_corr"):
            counts[name] = counts.get(name, 0) + 1
    return counts


def save_artifact(exported, directory: str, weights: Sequence[str],
                  extra_manifest: Optional[Dict[str, Any]] = None) -> str:
    """Write ``<directory>/{program.pt2,manifest.json}``; ``weights`` are the
    program's weight names (:func:`weight_names`). Returns the directory."""
    os.makedirs(directory, exist_ok=True)
    torch.export.save(exported, os.path.join(directory, PROGRAM_FILE))
    vals = {n.name: n.meta["val"] for n in exported.graph.nodes if n.op == "placeholder"}
    users = [vals[name] for name in exported.graph_signature.user_inputs]
    if len(users) != len(weights) + 5:
        raise ValueError(f"the program takes {len(users)} inputs; {len(weights)} weights "
                         "and 5 episode arrays expected")
    supp = users[-5]   # (shots, slices, H, W)
    manifest = {
        "format_version": FORMAT_VERSION,
        "torch_version": torch.__version__,
        "device_type": supp.device.type,
        "slices": int(supp.shape[1]),
        "shots": int(supp.shape[0]),
        "crop_size": [int(supp.shape[2]), int(supp.shape[3])],
        "weights": list(weights),
        "graph_nodes": sum(1 for _ in graph_nodes(exported)),
        "correlation_ops": correlation_ops(exported),
        "route_variables": {k: os.environ[k] for k in ROUTE_VARIABLES if k in os.environ},
    }
    manifest.update(extra_manifest or {})
    with open(os.path.join(directory, MANIFEST_FILE), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    return directory


class ServingProgram:
    """A reloaded artifact: call it as the live episode function, with the
    weight tuple first."""

    def __init__(self, exported, manifest: Dict[str, Any]):
        self.exported = exported
        self.manifest = manifest
        self.module = exported.module()

    def __call__(self, weights, *episode_arrays):
        return self.module(weights, *episode_arrays)


def load_artifact(directory: str, device="cuda") -> ServingProgram:
    """Reload an artifact written by :func:`save_artifact` for ``device``.

    Raises on a missing manifest or program, a corrupt program, a format
    newer than this loader, or a device type other than the program's;
    warns on another torch major version."""
    prog_path = os.path.join(directory, PROGRAM_FILE)
    man_path = os.path.join(directory, MANIFEST_FILE)
    for path in (man_path, prog_path):
        if not os.path.exists(path):
            raise FileNotFoundError(f"no {os.path.basename(path)} in {directory}")
    with open(man_path) as f:
        manifest = json.load(f)
    fv = manifest.get("format_version")
    if not isinstance(fv, int) or fv > FORMAT_VERSION:
        raise ValueError(f"artifact format {fv!r}; this loader reads formats up to "
                         f"{FORMAT_VERSION}")
    dev = torch.device(device).type
    if manifest.get("device_type") != dev:
        raise ValueError(f"artifact exported for {manifest.get('device_type')!r}, asked to "
                         f"serve on {dev!r}: the program's factory tensors carry their "
                         "device; export again for this one")
    tv = manifest.get("torch_version", "")
    if tv.split(".")[0] != torch.__version__.split(".")[0]:
        warnings.warn(f"artifact exported with torch {tv}, running {torch.__version__}",
                      stacklevel=2)
    try:
        exported = torch.export.load(prog_path)
    except Exception as e:   # torch raises several types for a damaged archive
        raise ValueError(f"{prog_path} is not a loadable program: {e}") from e
    return ServingProgram(exported, manifest)


def make_artifact_runner(program: ServingProgram, state_dict, config, device):
    """An ``EpisodeRunner`` driven by a reloaded artifact, with no model
    built: the live runner's pinned uploads, device volume cache,
    ``dispatch``/``dispatch_spec``/``finalize`` and per-episode CUDA events,
    so ``cli.test_rpnet.run_eval_protocol`` runs unchanged on it.
    ``state_dict`` (a ``.pth``'s) must hold every weight the manifest
    names. Episodes are padded to the artifact's ``slices`` query slices
    (images -1, labels 0, ``slice_mask`` 0) and longer ones truncated, as
    the JAX artifact runner does."""
    from rpnet_tpu_torch.episode.pipeline import EpisodeRunner

    names = program.manifest["weights"]
    missing = [n for n in names if n not in state_dict]
    if missing:
        raise ValueError(f"checkpoint does not cover {len(missing)} of the artifact's "
                         f"weights (e.g. {missing[0]})")
    weights = tuple(state_dict[n].detach().float().to(device) for n in names)
    return EpisodeRunner(None, config, device, slices=int(program.manifest["slices"]),
                         fn=lambda *episode: program(weights, *episode))
