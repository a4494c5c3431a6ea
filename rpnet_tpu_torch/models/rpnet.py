"""RP_Net forward, eval and training (net/rp_net.py:184-440).

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

The backbone is the U-Net (optionally with mask injection), VGG16, a
ResNet18-style encoder or SAM's ViT image encoder (``sam_vit``,
``models/sam_vit.py``); VGG and ResNet take the single-channel image
broadcast to 3 channels, the ViT takes it resized to its ``img_size`` and
broadcast to 3 channels, in micro-batches (``SamViTEncoder.encode``). In
the merged eval pass the encoder gets each support's foreground mask and,
for the query, support (0, 0)'s mask, as the JAX package passes
``fore_mask[0, 0]`` (its rpnet.py:190-196). The relation mode is the CRE
(``relation``) or :class:`SimpleConcat` (``concat``).

The refinement loop is a Python loop. Tensors are channels-last as in the
JAX package.

Training (``model.train()``) follows ``RPNet.__call__(train=True)`` under
the JAX trainer's vmap over E episodes, with the episodes folded into the
slice axis (episode-major), so each CRE call launches the correlation
kernels once for all episodes:
  * supports and query are encoded in two passes, as upstream: batch norm
    statistics are per pass and per episode (``blocks.BatchNorm2d``);
  * running statistics update on every pass in order: encoder (supports,
    then query), the CRE on each support, then each refinement iteration;
  * the PANet align loss (rp_net.py:394-440) is computed per episode.
"""

from __future__ import annotations

import torch
from torch import nn

from rpnet_tpu_torch.models.blocks import set_episode_groups
from rpnet_tpu_torch.models.cre import ContextCorrelationEncoder, SimpleConcat
from rpnet_tpu_torch.models.losses import one_hot
from rpnet_tpu_torch.models.resnet import ResNet18Encoder
from rpnet_tpu_torch.models.sam_vit import SamViTEncoder
from rpnet_tpu_torch.models.unet import UNet
from rpnet_tpu_torch.models.vgg import VGGEncoder
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
    n1 = _norm(fts).clamp_min(COSINE_EPS)
    n2 = _norm(proto).clamp_min(COSINE_EPS)
    return dot / (n1 * n2) * scaler


def _norm(x):
    """2-norm over the last axis; below f32 as ``jnp.linalg.norm`` computes
    it, sqrt(sum(x·x)) with the squares, the sum and the root each rounded."""
    if x.dtype.itemsize < 4:
        return torch.sqrt(torch.sum(x * x, dim=-1))
    return torch.linalg.vector_norm(x, dim=-1)


def masked_average_pool(fts, mask):
    """getFeatures (net/rp_net.py:366-376) without the upsample.

    fts (B, h, w, C) features; mask (B, H, W) full-resolution → (B, C) f32.
    sum(upsample(fts) * mask) == sum(fts * upsampleᵀ(mask)). The mask is
    resized in its own dtype (the network's: bf16 in eval, each of the two
    resize products rounded), then the spatial sums run in f32, as
    ``rpnet_tpu/models/rpnet.py:64-82`` does.
    """
    h, w = fts.shape[1:3]
    m_down = resize_transpose(mask[..., None], (h, w)).float()   # (B, h, w, 1)
    num = torch.sum(fts.float() * m_down, dim=(1, 2))
    den = torch.sum(mask.float(), dim=(1, 2))[:, None] + 1e-5
    return num / den


class RPNet(nn.Module):
    """Few-shot segmentation with recurrent mask refinement.

    Eval inputs (channels-last; Wa=ways, Sh=shots, B=slices):
      supp_imgs (Wa, Sh, B, H, W, 1); fore_mask, back_mask (Wa, Sh, B, H, W);
      qry_imgs (B, H, W, 1); appr_query_labels (B, H, W), the registration prior.
    Returns {'output': (B, H, W, 1+Wa) logits, 'refinement': (T, B, H, W, 1+Wa)}.

    Training inputs carry a leading episode axis E on each of those
    (supp_imgs (E, Wa, Sh, B, H, W, 1), ..., appr_query_labels (E, B, H, W));
    the outputs then lead with (E, B) and add 'align_loss' (E,), zero when
    ``align`` is off.
    """

    def __init__(self, scale: int = 4, num_iter: int = 10, radius: int = 5,
                 soft_mask: bool = False, align: bool = True, backbone: str = "UNet",
                 mask_feature_map="no", use_relation_enc: str = "relation",
                 norm: str = "BatchNorm2d", sam_vit: dict | None = None):
        super().__init__()
        self.scale = scale
        self.num_iter = num_iter
        self.soft_mask = soft_mask
        self.align = align
        self.backbone = backbone
        self.use_relation_enc = use_relation_enc
        if backbone == "UNet":
            self.encoder = UNet(mask_feature_map=mask_feature_map, norm=norm)
        elif backbone == "vgg":
            self.encoder = VGGEncoder()
        elif backbone == "resnet":
            self.encoder = ResNet18Encoder()
        elif backbone == "sam_vit":
            self.encoder = SamViTEncoder(**(sam_vit or {}))
        else:
            raise NotImplementedError(f"backbone {backbone!r}: vgg, UNet, resnet or sam_vit")
        C = self.encoder.out_channels
        if use_relation_enc == "relation":
            self.cre = ContextCorrelationEncoder(C, radius)
        elif use_relation_enc == "concat":
            self.sim_cat = SimpleConcat(C)
        else:
            raise NotImplementedError(f"use_relation_enc {use_relation_enc!r}: "
                                      "relation or concat")

    def _encode(self, imgs, masks):
        """imgs (N, H, W, 1), masks (N, H, W) or None when the encoder takes
        no mask → features (N, h, w, C)."""
        if self.backbone == "sam_vit":
            return self.encoder.encode(imgs)
        if self.backbone != "UNet":
            return self.encoder(imgs.expand(-1, -1, -1, 3).contiguous())
        return self.encoder(imgs, None if masks is None else masks[..., None])

    def _relate(self, fts, mask_ds):
        if self.use_relation_enc == "concat":
            return self.sim_cat(fts, mask_ds)
        return self.cre(fts * mask_ds, fts * (1.0 - mask_ds))

    def _predict(self, qry_fts, fg_proto, bg_proto, img_size):
        """Cosine distances vs prototypes → upsampled logits (B, H, W, 1+Wa)."""
        dists = [cosine_distance(qry_fts, bg_proto)]
        dists += [cosine_distance(qry_fts, p) for p in fg_proto]
        return interpolate_bilinear(torch.stack(dists, dim=-1), img_size)

    def forward(self, supp_imgs, fore_mask, back_mask, qry_imgs, appr_query_labels):
        if self.training:
            return self._forward_train(supp_imgs, fore_mask, back_mask, qry_imgs,
                                       appr_query_labels)
        Wa, Sh, B, H, W = fore_mask.shape
        imgs = torch.cat([supp_imgs.reshape(Wa * Sh * B, H, W, 1),
                          qry_imgs.reshape(B, H, W, 1)])
        masks = None
        if getattr(self.encoder, "mask_level", 0):
            masks = torch.cat([fore_mask.reshape(Wa * Sh * B, H, W), fore_mask[0, 0]])
        fts = self._encode(imgs, masks)                # ((Wa*Sh+1)*B, h, w, C)
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

    def _forward_train(self, supp_imgs, fore_mask, back_mask, qry_imgs, appr):
        E, Wa, Sh, B, H, W = fore_mask.shape
        set_episode_groups(self, E)
        # two encoder passes, episode-major (rp_net.py:245-262)
        supp_fts_raw = self._encode(supp_imgs.reshape(E * Wa * Sh * B, H, W, 1),
                                    fore_mask.reshape(E * Wa * Sh * B, H, W))
        qry_fts = self._encode(qry_imgs.reshape(E * B, H, W, 1),
                               fore_mask[:, 0, 0].reshape(E * B, H, W))
        h, w, C = qry_fts.shape[1:]
        supp_fts_raw = supp_fts_raw.reshape(E, Wa, Sh, B, h, w, C)

        qry_mask = avg_pool2d(appr.reshape(E * B, H, W, 1), self.scale)
        supp_mask = avg_pool2d(fore_mask.reshape(E * Wa * Sh * B, H, W, 1), self.scale)
        supp_mask = supp_mask.reshape(E, Wa, Sh, B, h, w, 1)

        def fold(a, *shape):   # (E, B, ...) → (E·B, ...)
            return a.reshape((E * B,) + tuple(shape))

        supp_fts, fg, bg = [], [], []
        for w_ in range(Wa):
            sf_w, fg_s, bg_s = [], [], []
            for s_ in range(Sh):
                sf = self._relate(fold(supp_fts_raw[:, w_, s_], h, w, C),
                                  fold(supp_mask[:, w_, s_], h, w, 1))
                sf_w.append(sf)
                fg_s.append(masked_average_pool(sf, fold(fore_mask[:, w_, s_], H, W)))
                bg_s.append(masked_average_pool(sf, fold(back_mask[:, w_, s_], H, W)))
            supp_fts.append(sf_w)
            fg.append(torch.stack(fg_s).mean(0))
            bg.append(torch.stack(bg_s).mean(0))
        fg_proto = torch.stack(fg).to(qry_fts.dtype)          # (Wa, E·B, C')
        bg_proto = torch.stack(bg).mean(0).to(qry_fts.dtype)  # (E·B, C')

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
        refinement = refinement.reshape((self.num_iter, E, B) + refinement.shape[2:])

        align_loss = torch.zeros(E, dtype=refinement.dtype, device=refinement.device)
        if self.align:
            # feature-resolution distances of the last iteration as `pred`
            # (rp_net.py:335-343)
            pred = torch.stack([cosine_distance(inter, bg_proto)]
                               + [cosine_distance(inter, p) for p in fg_proto], dim=-1)
            align_loss = self.align_loss(inter, pred, supp_fts, fore_mask, back_mask)
        return {"output": refinement[-1], "refinement": refinement,
                "align_loss": align_loss}

    def align_loss(self, qry_fts, pred, supp_fts, fore_mask, back_mask):
        """PANet prototype-alignment loss (net/rp_net.py:394-440), per episode.

        qry_fts (E·B, h, w, C'); pred (E·B, h, w, 1+Wa) feature-resolution
        distances; supp_fts[way][shot] (E·B, h, w, C'); masks
        (E, Wa, Sh, B, H, W). Query prototypes are taken over each episode's
        query slices; the reference's skip of ways with no predicted pixel is
        a multiplicative indicator, as in the JAX package. Returns (E,).
        """
        E, Wa, Sh, B, H, W = fore_mask.shape
        n_cls = 1 + Wa
        binary = one_hot(pred.argmax(dim=-1), n_cls, qry_fts.dtype)
        binary = binary.reshape(E, -1, n_cls)                       # (E, B·h·w, K)
        fts = qry_fts.reshape(E, -1, qry_fts.shape[-1])
        qsum = torch.einsum("enc,enk->ekc", fts, binary)
        qcnt = binary.sum(dim=1)                                    # (E, K)
        qry_protos = qsum / (qcnt[..., None] + 1e-5)                # (E, K, C')
        qry_protos = qry_protos.repeat_interleave(B, dim=0)         # (E·B, K, C')
        way_present = (qcnt[:, 1:] > 0).to(qry_fts.dtype)           # (E, Wa)

        loss = torch.zeros(E, dtype=qry_fts.dtype, device=qry_fts.device)
        for way in range(Wa):
            for shot in range(Sh):
                sf = supp_fts[way][shot]
                logits = torch.stack([cosine_distance(sf, qry_protos[:, 0]),
                                      cosine_distance(sf, qry_protos[:, way + 1])],
                                     dim=-1)
                logp = torch.log_softmax(interpolate_bilinear(logits, (H, W)), dim=-1)
                fm = fore_mask[:, way, shot].reshape(E * B, H, W)
                bm = back_mask[:, way, shot].reshape(E * B, H, W)
                # supp_label: fg = 1, then bg = 0 overwrites (rp_net.py:433-436)
                fg_w = fm * (1.0 - bm)
                ce = -(fg_w * logp[..., 1] + bm * logp[..., 0])
                valid = (fg_w + bm).reshape(E, -1).sum(dim=1)
                per_ep = ce.reshape(E, -1).sum(dim=1) / torch.clamp(valid, min=1.0)
                loss = loss + way_present[:, way] * per_ep / (Sh * Wa)
        return loss
