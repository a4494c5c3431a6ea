"""RP_Net episodic eval on SAM's ViT image encoder (``backbone: sam_vit``):
``rpnet_eval``'s cell, the eval CLI's own pass on the same runner, sampler
and registration, with what is U-Net-specific replaced:

  * the weights: ``weights.draw``'s, except where they would make the
    attention trivial: the LayerNorms' scales and shifts are drawn as batch
    norms' (U(0.8, 1.2), U(±0.1)) from the same uniforms, and ``pos_embed``
    at the scale of the patch embedding's output (the same normals, std √2:
    what a He-normal embedding gives pixels of unit RMS). The attention's
    mean entropy on one slice is printed against log N (``details``);
  * the features compared: the encoder's output (the neck's), gathered over
    its micro-batches;
  * the reference network: ``reference/sam_vit.py`` in place of the U-Net's,
    each episode's reference features computed once for both of the check's
    uses;
  * the work counted: the reference's FLOPs, row 1 at the encoder's
    ``out_chans``, and the attention calls for ``attention_roofline``.

A checkout whose program has no such backbone fails at once, before any
volume is made.
"""

from __future__ import annotations

import math
import os
import sys
import types

import torch
import torch.nn.functional as F
from torch import nn

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import attention_roofline  # noqa: E402
import harness  # noqa: E402
import roofline  # noqa: E402
import rpnet_eval  # noqa: E402
from reference import rpnet as ref_rpnet  # noqa: E402
from reference import sam_vit as ref_sam  # noqa: E402


def reference(widths: dict):
    """``reference.rpnet`` with its U-Net and network replaced by the ViT's:
    ``unet(imgs, sd, quant)`` gives the ViT's features and ``rpnet(...)`` the
    eval on them; the features of the last images seen are kept for each
    ``quant``, so an episode's encoder runs once for both."""
    kept = {}

    def features(imgs, sd, quant=None):
        hit = kept.get(quant)
        if hit is None or hit[0].shape != imgs.shape or not torch.equal(hit[0], imgs):
            kept[quant] = hit = (imgs, ref_sam.encoder(imgs, sd, widths, quant))
        return hit[1]

    def net(sd, supp, fore, back, qry, appr, num_iter, radius=5, scale=4, quant=None,
            masks=None):
        fts = features(torch.cat([supp, qry])[:, None], sd, quant)
        return ref_sam.rpnet(sd, supp, fore, back, qry, appr, num_iter, radius, scale, quant,
                             masks, widths=widths, features=fts)

    names = {k: getattr(ref_rpnet, k) for k in dir(ref_rpnet) if not k.startswith("__")}
    return types.SimpleNamespace(**dict(names, unet=features, rpnet=net))


@torch.no_grad()
def attention_entropy(sd, img, widths) -> dict:
    """Mean entropy of the attention's rows in the first windowed and the
    first global block, the reference's, on one crop (1, 1, H, W), with
    log N beside each."""
    S, p = widths["img_size"], "encoder."
    x = F.interpolate(img, size=(S, S), mode="bilinear", align_corners=False).expand(-1, 3, -1, -1)
    x = F.conv2d(x, sd[p + "patch_embed.proj.weight"], sd[p + "patch_embed.proj.bias"],
                 stride=widths["patch_size"]).permute(0, 2, 3, 1) + sd[p + "pos_embed"]
    heads, c = widths["num_heads"], widths["embed_dim"] // widths["num_heads"]
    out = {}
    for i in range(widths["depth"]):
        b = f"{p}blocks.{i}."
        kind = "global" if i in widths["global_attn_indexes"] else "windowed"
        if kind not in out:
            h = ref_sam.layer_norm(x, sd[b + "norm1.weight"], sd[b + "norm1.bias"])
            if kind == "windowed":
                w = widths["window_size"]
                h = F.pad(h, (0, 0, 0, -h.shape[2] % w, 0, -h.shape[1] % w))
                n = h.shape[1] // w
                h = h.reshape(n, w, n, w, -1).permute(0, 2, 1, 3, 4).reshape(-1, w, w, h.shape[-1])
            B, side = h.shape[0], h.shape[1]
            q, k = F.linear(h, sd[b + "attn.qkv.weight"], sd[b + "attn.qkv.bias"]).reshape(
                B, side * side, 3, heads, c).permute(2, 0, 3, 1, 4)[:2]
            rq = q.reshape(B, heads, side, side, c)
            rel_h = torch.einsum("bnhwc,hkc->bnhwk", rq, ref_sam.rel_table(sd[b + "attn.rel_pos_h"], side))
            rel_w = torch.einsum("bnhwc,wkc->bnhwk", rq, ref_sam.rel_table(sd[b + "attn.rel_pos_w"], side))
            s = ((q * c ** -0.5) @ k.transpose(-2, -1)).reshape(B, heads, side, side, side, side)
            logp = torch.log_softmax((s + rel_h[..., :, None] + rel_w[..., None, :]).reshape(
                B, heads, side * side, -1), -1)
            out[kind] = [float(-(logp.exp() * logp).sum(-1).mean()), math.log(side * side)]
        x = ref_sam.block(x, sd, b, heads, 0 if kind == "global" else widths["window_size"])
        if len(out) == 2:
            return out
    return out


class Cell(rpnet_eval.Cell):
    def setup(self):
        from rpnet_tpu_torch.models import sam_vit  # noqa: F401  (no backbone: fail here)

        super().setup()
        norms = {n for n, m in self.runner.model.named_modules() if isinstance(m, nn.LayerNorm)}
        for name, t in self.sd.items():
            prefix, _, leaf = name.rpartition(".")
            if prefix in norms:      # U(±0.05) as drawn → the batch norms' ranges
                u = (t + 0.05) / 0.1
                t.copy_(0.8 + 0.4 * u if leaf == "weight" else 0.2 * u - 0.1)
            elif leaf == "pos_embed":
                t.mul_(math.sqrt(math.prod(t.shape[1:])))
        self.runner.model.load_state_dict(self.sd)
        self.widths = self.config["sam_vit"]
        img, _ = ref_rpnet.preprocess(*self.volumes[next(iter(self.volumes))], self.config)
        img = torch.from_numpy(img[len(img) // 2][None, None]).to(self.run.device)
        with harness.full_f32():
            self.details = {"entropy": attention_entropy(self.sd, img, self.widths)}
        print("attention entropy (mean, log N): " + ", ".join(
            f"{k} {v[0]:.3f} of {v[1]:.3f}" for k, v in self.details["entropy"].items()),
            file=sys.stderr)

    def _wrap(self):
        super()._wrap()
        self.hooks[1].remove()     # the encoder runs once a micro-batch: gather them

        def keep_features(module, args, output):
            if self.capturing is not None:
                self.capturing.setdefault("feature_parts", []).append(output.detach())

        self.hooks[1] = self.runner.model.encoder.register_forward_hook(keep_features)

    def _count_work(self, records):
        run, cfg, widths = self.run, self.config, self.widths
        T, r, sc = (int(cfg["n_iter_refinement"]), int(cfg["mask_refinement_correlation_radius"]),
                    int(cfg["scale"]))
        H, W = cfg["crop_size"]
        h, w, C = H // sc, W // sc, int(widths["out_chans"])
        meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in self.sd.items()}
        per_slice = roofline.counted_flops(ref_sam.encoder, torch.empty((1, 1, H, W), device="meta"),
                                           meta, widths)
        rest, calls = {}, []
        for rec in records:
            n = rec["spec"].n_slices
            if n not in rest:
                x = torch.empty((n, H, W), device="meta")
                fts = torch.empty((2 * n, C, h, w), device="meta")
                rest[n] = roofline.counted_flops(ref_sam.rpnet, meta, x, x, x, x, x, T, r, sc,
                                                 widths=widths, features=fts)
            shape = (n, h, w, C)
            run.corr_calls += [(shape, r, "bfloat16", False)] * (1 + T)
            calls += attention_roofline.calls(2 * n, widths)
            run.work_flops = ((run.work_flops or 0.0) + 2 * n * per_slice + rest[n]
                              + (1 + T) * roofline.corr_products(shape, r))
        run.attn_calls = calls
        run.peak_unit = roofline.UNIT_OF_DTYPE["bfloat16"]

    def check(self, control: bool = False):
        for rec in self.records:
            parts = rec.pop("feature_parts", None)
            if parts:
                rec["features"] = torch.cat(parts)
        saved = rpnet_eval.ref
        rpnet_eval.ref = reference(self.widths)
        try:
            return super().check(control)
        finally:
            rpnet_eval.ref = saved
