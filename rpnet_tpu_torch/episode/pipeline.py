"""One episode: registration + network + metrics.

The counterpart of ``rpnet_tpu/episode/pipeline.py`` for the reference's
shot-0 path (only shot 0 is registered and fed to the network; the eval
reader discards the other shots, few_shot_reader.py:521-548):

  1. the batched affine fit and warps, f32 (``registration/fit.py``);
  2. the network, in ``compute_dtype`` (default bfloat16: parameters, BN
     statistics and inputs are cast; ``compute_dtype: float32`` pins f32);
  3. Dice and NCC in f32, packed into one vector in the JAX package's layout
     ``[dsc_affine, dsc_fewshot, gt_nonempty, ncc_warped, ncc_raw,
     dsc_refinement[0..T-1]]``.

Episodes longer than ``max_slices`` are truncated to it, as the JAX runner
does. Its padding of the slice axis to ``slice_bucket`` exists for XLA's
static shapes; every stage is per slice, so dropping it changes no metric.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from rpnet_tpu_torch.core.metrics import dice, ncc
from rpnet_tpu_torch.episode.sampler import Episode
from rpnet_tpu_torch.registration.fit import register_episode


def episode_metrics_fn(model, affine_iters: int, fit_scale: int = 1,
                       compute_dtype=torch.float32, reg_lr: float = 0.01):
    """The episode function for ``model`` (already cast to ``compute_dtype``)."""

    def fn(supp_img, supp_lab, qry_img, qry_lab, slice_mask):
        """supp_img/supp_lab: (Sh, Dq, H, W); qry_*: (Dq, H, W); mask: (Dq,)."""
        reg = register_episode(supp_img[0], qry_img, supp_lab[0],
                               affine_iters=affine_iters, lr=reg_lr,
                               fit_scale=fit_scale)
        appr = reg.warped_label                         # (Dq, H, W)
        fore = reg.affine_label[None, None]
        cast = lambda a: a.to(compute_dtype)
        with torch.no_grad():
            out = model(cast(reg.affine_src[None, None, ..., None]), cast(fore),
                        cast(1.0 - fore), cast(qry_img[..., None]), cast(appr))
        refinement = out["refinement"].float()
        ref_preds = (torch.softmax(refinement, dim=-1)[..., 1] > 0.5).float()

        w = slice_mask
        dsc_affine, affine_valid = dice(appr, qry_lab, weight=w)
        dsc_fewshot, _ = dice(ref_preds[-1], qry_lab, weight=w)
        dsc_ref = torch.stack([dice(p, qry_lab, weight=w)[0] for p in ref_preds])
        w3 = w[:, None, None]
        ncc_warped = ncc(reg.warped_src, qry_img, weight=w3)
        ncc_raw = ncc(supp_img[0], qry_img, weight=w3)
        return torch.cat([torch.stack([dsc_affine, dsc_fewshot,
                                       affine_valid.float(), ncc_warped,
                                       ncc_raw]), dsc_ref])

    return fn


class EpisodeRunner:
    """Runs episodes through :func:`episode_metrics_fn` on one device."""

    def __init__(self, model, config, device):
        for key, ported in (("do_deformable", False), ("multishot_fusion", False),
                            ("use_registration_loss", True), ("n_way", 1)):
            if config.get(key, ported) != ported:
                raise NotImplementedError(
                    f"{key}: {config.get(key)!r} is not ported to rpnet_tpu_torch "
                    f"yet (ported: {ported!r})")
        self.device = torch.device(device)
        self.max_slices = int(config.get("max_slices", 288))
        compute_dtype = getattr(torch, config.get("compute_dtype") or "bfloat16")
        if compute_dtype == torch.float32 and self.device.type == "cuda":
            # f32 means f32: cuDNN convolutions default to TF32
            torch.backends.cudnn.allow_tf32 = False
        self.model = model.to(device=self.device, dtype=compute_dtype).eval()
        self.fn = episode_metrics_fn(self.model,
                                     int(config.get("reg_affine_iters", 50)),
                                     int(config.get("reg_fit_scale", 1)),
                                     compute_dtype,
                                     float(config.get("reg_lr", 0.01)))

    def run(self, ep: Episode) -> Dict[str, Any]:
        """Run one episode; the scalar metrics with the host conventions
        (None for empty ground truth, utils/util.py:388-389)."""
        take = min(ep.n_slices, self.max_slices)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a[..., :take, :, :])).to(self.device)

        with torch.no_grad():
            packed = self.fn(dev(ep.support_images), dev(ep.support_labels),
                             dev(ep.query_images), dev(ep.query_labels),
                             torch.ones(take, device=self.device))
        packed = packed.cpu().numpy()
        nonempty = bool(packed[2] > 0.5)
        return {
            "dsc_affine": float(packed[0]) if nonempty else None,
            "dsc_fewshot": float(packed[1]) if nonempty else None,
            "dsc_refinement": {i: (float(v) if nonempty else None)
                               for i, v in enumerate(packed[5:])},
            "ncc_warped": float(packed[3]),
            "ncc_raw": float(packed[4]),
            "n_slices": ep.n_slices,
        }
