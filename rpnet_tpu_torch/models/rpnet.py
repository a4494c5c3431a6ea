"""RP_Net eval forward (net/rp_net.py:184-440).

The counterpart of ``rpnet_tpu/models/rpnet.py``:

  encoder → context relation features (CRE) → masked-average-pool
  prototypes → cosine-distance prediction → recurrent refinement.

Kept from the JAX package (same values as upstream):
  * one merged encoder pass over supports and query (eval BN is per-sample,
    so the merge is value-exact);
  * prototypes are loop-invariant and computed once before the refinement;
  * ``output`` is the last refinement iteration's logits (the upstream final
    pass evaluates the same prototypes against the same query features);
  * masked average pooling applies the transpose of the bilinear upsampler to
    the mask instead of upsampling the features; its spatial sums run in f32
    and are cast back to the network dtype after the reductions.

The refinement loop is a Python loop. Tensors are channels-last as in the
JAX package. Only the eval forward is ported; the align loss and training
semantics are later work (ROADMAP.md).
"""

from __future__ import annotations

import torch
from torch import nn

from rpnet_tpu_torch.models.cre import ContextCorrelationEncoder
from rpnet_tpu_torch.models.unet import UNet
from rpnet_tpu_torch.ops.sampling import (avg_pool2d, interpolate_bilinear,
                                          resize_transpose)

COSINE_EPS = 1e-8
DIST_SCALER = 20.0   # cosine similarity × 20 (rp_net.py:353-363)


def cosine_distance(fts, prototype, scaler: float = DIST_SCALER):
    """calDist (net/rp_net.py:353-363): cosine similarity × scaler, each
    norm clamped at 1e-8 on its own (``F.cosine_similarity`` clamps the
    product instead). fts (B, h, w, C); prototype (B, C) → (B, h, w)."""
    proto = prototype[:, None, None, :]
    dot = torch.sum(fts * proto, dim=-1)
    n1 = torch.linalg.vector_norm(fts, dim=-1).clamp_min(COSINE_EPS)
    n2 = torch.linalg.vector_norm(proto, dim=-1).clamp_min(COSINE_EPS)
    return dot / (n1 * n2) * scaler


def masked_average_pool(fts, mask):
    """getFeatures (net/rp_net.py:366-376) without the upsample, in f32.

    fts (B, h, w, C) features; mask (B, H, W) full-resolution → (B, C) f32.
    sum(upsample(fts) * mask) == sum(fts * upsampleᵀ(mask)).
    """
    h, w = fts.shape[1:3]
    m_down = resize_transpose(mask.float()[..., None], (h, w))   # (B, h, w, 1)
    num = torch.sum(fts.float() * m_down, dim=(1, 2))
    den = torch.sum(mask.float(), dim=(1, 2))[:, None] + 1e-5
    return num / den


class RPNet(nn.Module):
    """Few-shot segmentation with recurrent mask refinement (eval forward).

    Inputs (channels-last; Wa=ways, Sh=shots, B=slices):
      supp_imgs (Wa, Sh, B, H, W, 1); fore_mask, back_mask (Wa, Sh, B, H, W);
      qry_imgs (B, H, W, 1); appr_query_labels (B, H, W), the registration prior.
    Returns {'output': (B, H, W, 1+Wa) logits, 'refinement': (T, B, H, W, 1+Wa)}.
    """

    def __init__(self, scale: int = 4, num_iter: int = 10, radius: int = 5,
                 soft_mask: bool = False):
        super().__init__()
        self.scale = scale
        self.num_iter = num_iter
        self.soft_mask = soft_mask
        self.encoder = UNet()
        self.cre = ContextCorrelationEncoder(256, radius)

    def _relate(self, fts, mask_ds):
        return self.cre(fts * mask_ds, fts * (1.0 - mask_ds))

    def _predict(self, qry_fts, fg_proto, bg_proto, img_size):
        """Cosine distances vs prototypes → upsampled logits (B, H, W, 1+Wa)."""
        dists = [cosine_distance(qry_fts, bg_proto)]
        dists += [cosine_distance(qry_fts, p) for p in fg_proto]
        return interpolate_bilinear(torch.stack(dists, dim=-1), img_size)

    def forward(self, supp_imgs, fore_mask, back_mask, qry_imgs, appr_query_labels):
        if self.training:
            raise NotImplementedError("rpnet_tpu_torch ports the eval forward only")
        Wa, Sh, B, H, W = fore_mask.shape
        imgs = torch.cat([supp_imgs.reshape(Wa * Sh * B, H, W, 1),
                          qry_imgs.reshape(B, H, W, 1)])
        fts = self.encoder(imgs)                       # ((Wa*Sh+1)*B, h, w, C)
        supp_fts_raw = fts[:-B].reshape((Wa, Sh, B) + fts.shape[1:])
        qry_fts = fts[-B:]

        # the registration prior enters as the initial query mask (rp_net.py:269-270)
        qry_mask = avg_pool2d(appr_query_labels[..., None], self.scale)
        supp_mask = avg_pool2d(fore_mask.reshape(Wa * Sh * B, H, W, 1), self.scale)
        supp_mask = supp_mask.reshape((Wa, Sh, B) + supp_mask.shape[1:])

        fg, bg = [], []
        for w_ in range(Wa):
            fg_s, bg_s = [], []
            for s_ in range(Sh):
                sf = self._relate(supp_fts_raw[w_, s_], supp_mask[w_, s_])
                fg_s.append(masked_average_pool(sf, fore_mask[w_, s_]))
                bg_s.append(masked_average_pool(sf, back_mask[w_, s_]))
            fg.append(torch.stack(fg_s).mean(0))      # average over shots
            bg.append(torch.stack(bg_s).mean(0))
        fg_proto = torch.stack(fg).to(fts.dtype)       # (Wa, B, C)
        bg_proto = torch.stack(bg).mean(0).to(fts.dtype)   # (B, C)

        refinement = []
        for _ in range(self.num_iter):
            inter = self._relate(qry_fts, qry_mask)
            logits = self._predict(inter, fg_proto, bg_proto, (H, W))
            probs = torch.softmax(logits, dim=-1)[..., 1]
            if not self.soft_mask:
                probs = (probs > 0.5).to(logits.dtype)
            qry_mask = avg_pool2d(probs[..., None], self.scale)
            refinement.append(logits)
        refinement = torch.stack(refinement)
        return {"output": refinement[-1], "refinement": refinement}
