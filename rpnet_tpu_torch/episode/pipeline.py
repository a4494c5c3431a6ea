"""One episode: registration + network + metrics, and the eval runner.

The counterpart of ``rpnet_tpu/episode/pipeline.py``. The episode function:

  1. registration, f32 (``registration/fit.py``): affine, then with
     ``do_deformable`` demons in the ``reg_sampler`` structure; shot 0
     registered onto every query slice (the reference path; the eval reader
     discards the other shots, few_shot_reader.py:521-548); with
     ``multishot_fusion`` and more than one shot every shot in one batched
     fit, the prior being the mean of the shots' warped labels > 0.5; with
     ``use_registration_loss: False`` none, the raw support and its label
     feeding the network;
  2. with ``n_way`` > 1 the supports tiled over the ways (the reference
     replicates them, few_shot_reader.py:294-298), so the softmax runs over
     1 + n_way channels;
  3. the network, in ``compute_dtype`` (default bfloat16: parameters, BN
     statistics and inputs are cast; ``compute_dtype: float32`` pins f32);
  4. Dice and NCC in f32, packed into one vector in the JAX package's layout
     ``[dsc_affine, dsc_fewshot, gt_nonempty, ncc_warped, ncc_raw,
     dsc_refinement[0..T-1]]``.

The runner splits an episode into :meth:`EpisodeRunner.dispatch` (or
:meth:`~EpisodeRunner.dispatch_spec`), which queues the work and returns at
once, and :meth:`~EpisodeRunner.finalize`, which waits for that episode's
packed vector only, so the CLI can queue episode j before it settles j - 1.
Host arrays go up from pinned buffers without blocking the host, and the
packed vector comes back into one (with ``arrays``, the prediction and the
registration prior too, as uint8, for the whole-volume eval). ``dispatch_spec`` takes an
:class:`~rpnet_tpu_torch.episode.sampler.EpisodeSpec`: each ``(pid, roi)``
volume is uploaded once into an LRU on the device (``device_volume_cache``
entries; 0 turns it off) and the episode's slices are gathered there.

Episodes longer than ``max_slices`` are truncated to it, as the JAX runner
does. Its padding of the slice axis (and of cached volumes) to fixed sizes
exists for XLA's static shapes; every stage is per slice, so dropping it
changes no metric.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rpnet_tpu_torch.core.metrics import dice, ncc
from rpnet_tpu_torch.episode.sampler import Episode, EpisodeSpec
from rpnet_tpu_torch.registration.fit import register_episode
from rpnet_tpu_torch.utils.profiling import span


def episode_outputs_fn(model, affine_iters: int, fit_scale: int = 1,
                       compute_dtype=torch.float32, reg_lr: float = 0.01,
                       multishot: bool = False, use_registration: bool = True,
                       n_way: int = 1, demons_iters: int = 0,
                       reg_sigma: float = 2.0, reg_sampler: str = "matmul"):
    """The per-slice part of the episode function for ``model`` (already cast
    to ``compute_dtype``): ``fn(supp_img, supp_lab, qry_img)`` → (every
    refinement's mask (T, Dq, H, W), the registration prior (Dq, H, W), the
    warped support of shot 0 (Dq, H, W)). Every query slice is independent
    of the others (the affine fit's loss is a sum of per-slice means, eval
    batch norms read running statistics), so slices may run in any split."""

    def register(supp_img, supp_lab, qry_img):
        """→ (prior (Dq, H, W), network supports (1, Sh', Dq, H, W, 1), their
        labels (1, Sh', Dq, H, W), the warped support of shot 0)."""
        Sh, Dq, H, W = supp_img.shape
        kw = dict(affine_iters=affine_iters, demons_iters=demons_iters, lr=reg_lr,
                  sigma=reg_sigma, fit_scale=fit_scale, sampler=reg_sampler)
        if not use_registration:
            return (supp_lab[0], supp_img[0][None, None, ..., None],
                    supp_lab[0][None, None], supp_img[0])
        if multishot and Sh > 1:
            # every shot in one batched fit (the fit is per slice), shot-major
            reg = register_episode(supp_img.reshape(Sh * Dq, H, W),
                                   qry_img.repeat(Sh, 1, 1),
                                   supp_lab.reshape(Sh * Dq, H, W), **kw)
            prior = (reg.warped_label.reshape(Sh, Dq, H, W).mean(0) > 0.5).float()
            return (prior, reg.affine_src.reshape(1, Sh, Dq, H, W, 1),
                    reg.affine_label.reshape(1, Sh, Dq, H, W), reg.warped_src[:Dq])
        reg = register_episode(supp_img[0], qry_img, supp_lab[0], **kw)
        return (reg.warped_label, reg.affine_src[None, None, ..., None],
                reg.affine_label[None, None], reg.warped_src)

    def fn(supp_img, supp_lab, qry_img):
        """supp_img/supp_lab: (Sh, Dq, H, W); qry_img: (Dq, H, W)."""
        appr, supp_t, fore, warped_src = register(supp_img, supp_lab, qry_img)
        if n_way > 1:
            supp_t = supp_t.repeat(n_way, 1, 1, 1, 1, 1)
            fore = fore.repeat(n_way, 1, 1, 1, 1)
        cast = lambda a: a.to(compute_dtype)
        with span("network", qry_img.device):
            with torch.no_grad():
                out = model(cast(supp_t), cast(fore), cast(1.0 - fore),
                            cast(qry_img[..., None]), cast(appr))
            refinement = out["refinement"].float()
            ref_preds = (torch.softmax(refinement, dim=-1)[..., 1] > 0.5).float()
        return ref_preds, appr, warped_src

    return fn


def episode_metrics(ref_preds, appr, warped_src, supp_img0, qry_img, qry_lab, slice_mask):
    """Dice and NCC of an episode's outputs, f32, packed in the JAX layout
    (module doc). ``supp_img0`` is shot 0's support (Dq, H, W)."""
    w = slice_mask
    dsc_affine, affine_valid = dice(appr, qry_lab, weight=w)
    dsc_fewshot, _ = dice(ref_preds[-1], qry_lab, weight=w)
    dsc_ref = torch.stack([dice(p, qry_lab, weight=w)[0] for p in ref_preds])
    w3 = w[:, None, None]
    ncc_warped = ncc(warped_src, qry_img, weight=w3)
    ncc_raw = ncc(supp_img0, qry_img, weight=w3)
    return torch.cat([torch.stack([dsc_affine, dsc_fewshot, affine_valid.float(),
                                   ncc_warped, ncc_raw]), dsc_ref])


def episode_metrics_fn(model, *args, **kwargs):
    """The episode function for ``model`` (already cast to ``compute_dtype``;
    the arguments are :func:`episode_outputs_fn`'s): ``fn(...)`` → (packed
    metrics, last refinement's mask (Dq, H, W), prior)."""
    outputs = episode_outputs_fn(model, *args, **kwargs)

    def fn(supp_img, supp_lab, qry_img, qry_lab, slice_mask):
        """supp_img/supp_lab: (Sh, Dq, H, W); qry_*: (Dq, H, W); mask: (Dq,)."""
        ref_preds, appr, warped_src = outputs(supp_img, supp_lab, qry_img)
        packed = episode_metrics(ref_preds, appr, warped_src, supp_img[0], qry_img,
                                 qry_lab, slice_mask)
        return packed, ref_preds[-1], appr

    return fn


@dataclasses.dataclass
class Dispatched:
    """A queued episode: its packed vector (on the host once ``done`` has
    completed), its slice count, the pinned buffers its copies read, and
    with ``arrays`` its (prediction, prior) as uint8 host tensors."""
    packed: torch.Tensor
    done: Any                       # torch.cuda.Event, None on the CPU
    n_slices: int
    keep: List[torch.Tensor]
    arrays: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


class EpisodeRunner:
    """Runs episodes through :func:`episode_metrics_fn`, on one device or
    with ``mesh`` over its ``data`` devices.

    ``fn`` takes the place of the model's episode function (``model`` is
    then None): ``serve/export.py``'s reloaded program. With ``slices``
    every episode is padded (images -1, labels 0, ``slice_mask`` 0) or
    truncated to that many query slices, the static shape of an exported
    program; the outputs are cut back to the episode's own slices.

    With ``mesh`` (``parallel/mesh.LocalMesh``) the query-slice axis is
    split over the mesh's data devices (``rpnet_tpu/episode/pipeline.py:
    226-246``): the model is cast once and copied to each distinct data
    device; each shard runs registration, network and refinement on its
    device, enqueued in turn by this thread; the per-slice outputs are
    copied to the first device (``mesh.first``, which is ``device``), where
    :func:`episode_metrics` packs the vector from the whole episode. A
    ``model`` axis > 1 runs each row's first device alone (the JAX runner
    repeats the row's work on its other devices). ``bucket`` and
    ``max_slices`` are rounded up to a multiple of the data axis, as the JAX
    runner rounds them; the whole-volume eval's window is ``bucket``. The
    spec path keeps its volume cache on every data device and each device
    gathers its own rows. ``shard_launches[k]`` counts the forward
    correlation launches of data shard ``k`` (``ops.correlation.
    forward_launches`` read around each shard's enqueue)."""

    def __init__(self, model, config, device, *, fn=None, slices: Optional[int] = None,
                 mesh=None):
        if mesh is not None and (fn is not None or slices is not None):
            raise ValueError("an exported episode program (fn, slices) runs on one device")
        self.mesh = mesh
        self.device = torch.device(mesh.first if mesh is not None else device)
        n_data = mesh.shape["data"] if mesh is not None else 1
        round_up = lambda n: -(-int(n) // n_data) * n_data
        self.slices = slices
        self.bucket = round_up(config.get("slice_bucket", 32))
        self.max_slices = int(slices or round_up(config.get("max_slices", 288)))
        self.devices = ([torch.device(d) for d in mesh.data_devices] if mesh is not None
                        else [self.device])
        self.shard_launches = [0] * n_data
        self.model, self.models = model, []
        if fn is None:
            # f32 leaves cuDNN's convolutions at torch's default (TF32), as the
            # JAX package leaves its f32 ones at XLA's default precision
            compute_dtype = getattr(torch, config.get("compute_dtype") or "bfloat16")
            self.model = model.to(device=self.device, dtype=compute_dtype).eval()
            kw = dict(affine_iters=int(config.get("reg_affine_iters", 50)),
                      fit_scale=int(config.get("reg_fit_scale", 1)),
                      compute_dtype=compute_dtype,
                      reg_lr=float(config.get("reg_lr", 0.01)),
                      multishot=bool(config.get("multishot_fusion", False)),
                      use_registration=bool(config.get("use_registration_loss", True)),
                      n_way=int(config.get("n_way", 1)),
                      demons_iters=(int(config.get("reg_demons_iters", 50))
                                    if config.get("do_deformable", False) else 0),
                      reg_sigma=float(config.get("reg_sigma", 2.0)),
                      reg_sampler=str(config.get("reg_sampler", "matmul")))
            self.models = [self.model]
            if mesh is None:
                fn = episode_metrics_fn(self.model, **kw)
            else:
                from rpnet_tpu_torch.parallel.mesh import module_replicas
                replicas = module_replicas(self.model, self.devices)
                self.models = list(replicas.values())
                self._outputs = {d: episode_outputs_fn(m, **kw) for d, m in replicas.items()}
        self.fn = fn
        self._dev_vols: "OrderedDict[Tuple[str, str], Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]]]" \
            = OrderedDict()
        self._dev_vols_max = int(config.get("device_volume_cache", 16))
        self.supports_spec = self._dev_vols_max > 0

    def _bounds(self, n: int) -> List[Tuple[int, int]]:
        """The data shards' row ranges of ``n`` slices, as
        ``parallel/mesh.shard_slices`` splits them (the empty ones left out)."""
        sizes = [len(a) for a in np.array_split(np.arange(n), len(self.devices))]
        edges = np.cumsum([0] + sizes)
        return [(int(a), int(b)) for a, b in zip(edges[:-1], edges[1:]) if b > a]

    def _run(self, supp_img, supp_lab, qry_img, qry_lab, parts=None):
        """The episode function on the episode's slices, padded to ``slices``
        where it is set; with a mesh over ``parts``, each data shard's
        (supp_img, supp_lab, qry_img) on its device (by default split from
        the whole episode's tensors)."""
        n = qry_img.shape[0]
        if self.mesh is not None:
            return self._run_sharded(supp_img, supp_lab, qry_img, qry_lab, parts)
        if self.slices is None:
            return self.fn(supp_img, supp_lab, qry_img, qry_lab,
                           torch.ones(n, device=self.device))
        pad = (0, 0, 0, 0, 0, self.slices - n)   # the slice axis
        mask = (torch.arange(self.slices, device=self.device) < n).float()
        packed, pred, prior = self.fn(
            F.pad(supp_img, pad, value=-1.0), F.pad(supp_lab, pad),
            F.pad(qry_img, pad, value=-1.0), F.pad(qry_lab, pad), mask)
        return packed, pred[:n], prior[:n]

    def _run_sharded(self, supp_img, supp_lab, qry_img, qry_lab, parts):
        from rpnet_tpu_torch.ops.correlation import forward_launches
        from rpnet_tpu_torch.parallel.mesh import gather_slices

        if parts is None:
            parts = [(supp_img[:, a:b].to(d, non_blocking=True),
                      supp_lab[:, a:b].to(d, non_blocking=True),
                      qry_img[a:b].to(d, non_blocking=True))
                     for (a, b), d in zip(self._bounds(qry_img.shape[0]), self.devices)]
        outs = []
        for k, (si, sl, qi) in enumerate(parts):
            before = forward_launches()
            outs.append(self._outputs[qi.device](si, sl, qi))
            self.shard_launches[k] += forward_launches() - before
        ref_preds, appr, warped_src = (gather_slices([o[i] for o in outs], self.device,
                                                     axis=1 if i == 0 else 0)
                                       for i in range(3))
        packed = episode_metrics(ref_preds, appr, warped_src, supp_img[0], qry_img, qry_lab,
                                 torch.ones(qry_img.shape[0], device=self.device))
        return packed, ref_preds[-1], appr

    def _upload(self, a: np.ndarray, keep: List[torch.Tensor], device=None) -> torch.Tensor:
        """``a`` on ``device`` (the runner's by default). On the card through
        a pinned buffer (added to ``keep``) by a copy that does not block the
        host; on the CPU a copy."""
        device = self.device if device is None else torch.device(device)
        a = np.ascontiguousarray(a)
        if device.type != "cuda":
            return torch.from_numpy(a.copy())
        pinned = torch.empty(a.shape, dtype=torch.from_numpy(np.empty(0, a.dtype)).dtype,
                             pin_memory=True)
        pinned.numpy()[...] = a
        keep.append(pinned)
        return pinned.to(device, non_blocking=True)

    def _device_volume(self, sampler, key, keep):
        """(pid, roi) → {device: (image f32, label uint8)} on every data
        device, LRU-cached."""
        hit = self._dev_vols.get(key)
        if hit is not None:
            self._dev_vols.move_to_end(key)
            return hit
        img, lab = sampler.load_image_and_mask(*key)
        # labels are exactly {0, 1}: uint8 holds them exactly
        img, lab = img.astype(np.float32, copy=False), lab.astype(np.uint8)
        pairs = {}
        for d in self.devices:
            if d not in pairs:
                pairs[d] = (self._upload(img, keep, d), self._upload(lab, keep, d))
        self._dev_vols[key] = pairs
        if len(self._dev_vols) > self._dev_vols_max:
            self._dev_vols.popitem(last=False)
        return pairs

    def _spec_rows(self, spec: EpisodeSpec, sampler, device, lo: int, hi: int, keep):
        """Rows ``lo:hi`` of an index-only episode, gathered on ``device``
        from its cached volumes (``index_select``; the query's ``qry_rows``,
        or its first slices), labels widened to f32 there → (supp_img,
        supp_lab, qry_img, qry_lab)."""
        sv, sl = self._device_volume(sampler, spec.supp_key, keep)[device]
        qv, ql = self._device_volume(sampler, spec.qry_key, keep)[device]
        shots = spec.supp_rows.shape[0]
        rows = self._upload(spec.supp_rows[:, lo:hi].astype(np.int64).ravel(), keep, device)
        shape = (shots, hi - lo) + tuple(sv.shape[1:])
        if spec.qry_rows is None:
            qry_img, qry_lab = qv[lo:hi], ql[lo:hi]
        else:
            qrows = self._upload(spec.qry_rows[lo:hi].astype(np.int64), keep, device)
            qry_img, qry_lab = qv.index_select(0, qrows), ql.index_select(0, qrows)
        return (sv.index_select(0, rows).view(shape), sl.index_select(0, rows).view(shape).float(),
                qry_img, qry_lab.float())

    def dispatch_spec(self, spec: EpisodeSpec, sampler, arrays: bool = False) -> Dispatched:
        """Queue an index-only episode: its volumes from the device cache,
        its slices gathered on the device. Per episode only the row indices
        go up. With a mesh, each data device gathers its shard's rows and the
        first device the whole episode's, which its metrics read."""
        take = min(spec.n_slices, self.max_slices)
        keep: List[torch.Tensor] = []
        full = self._spec_rows(spec, sampler, self.device, 0, take, keep)
        parts = None
        if self.mesh is not None:
            parts = [tuple(a[..., lo:hi, :, :] for a in full[:3]) if d == self.device
                     else self._spec_rows(spec, sampler, d, lo, hi, keep)[:3]
                     for (lo, hi), d in zip(self._bounds(take), self.devices)]
        return self._queue(*full, spec.n_slices, keep, arrays, parts)

    def dispatch(self, ep: Episode, arrays: bool = False) -> Dispatched:
        """Queue an episode assembled on the host."""
        take = min(ep.n_slices, self.max_slices)
        keep: List[torch.Tensor] = []
        up = lambda a: self._upload(a[..., :take, :, :], keep)
        return self._queue(up(ep.support_images), up(ep.support_labels),
                           up(ep.query_images), up(ep.query_labels), ep.n_slices, keep,
                           arrays)

    def _queue(self, supp_img, supp_lab, qry_img, qry_lab, n_slices, keep, arrays,
               parts=None):
        """Run the episode function; with ``arrays`` also bring back its
        prediction and prior (exactly {0, 1}: uint8 holds them)."""
        with torch.no_grad():
            packed, pred, prior = self._run(supp_img, supp_lab, qry_img, qry_lab, parts)
        out = [packed] + ([pred.to(torch.uint8), prior.to(torch.uint8)] if arrays else [])
        if self.device.type != "cuda":
            return Dispatched(out[0], None, n_slices, keep, tuple(out[1:]) or None)
        host = [torch.empty(a.shape, dtype=a.dtype, pin_memory=True) for a in out]
        for h, a in zip(host, out):
            h.copy_(a, non_blocking=True)
        done = torch.cuda.Event()
        with torch.cuda.device(self.device):
            done.record()
        return Dispatched(host[0], done, n_slices, keep, tuple(host[1:]) or None)

    def finalize(self, d: Dispatched) -> Dict[str, Any]:
        """Wait for the episode's packed vector (that episode only) and apply
        the host conventions (None for empty ground truth,
        utils/util.py:388-389); with a dispatch's ``arrays``, also its
        ``prediction`` and ``appr_label`` (Dq, H, W) uint8 arrays."""
        if d.done is not None:
            d.done.synchronize()
        packed = d.packed.numpy()
        d.keep.clear()
        nonempty = bool(packed[2] > 0.5)
        result = {
            "dsc_affine": float(packed[0]) if nonempty else None,
            "dsc_fewshot": float(packed[1]) if nonempty else None,
            "dsc_refinement": {i: (float(v) if nonempty else None)
                               for i, v in enumerate(packed[5:])},
            "ncc_warped": float(packed[3]),
            "ncc_raw": float(packed[4]),
            "n_slices": d.n_slices,
        }
        if d.arrays is not None:
            result["prediction"], result["appr_label"] = (a.numpy() for a in d.arrays)
        return result

    def run(self, ep: Episode) -> Dict[str, Any]:
        return self.finalize(self.dispatch(ep))
