"""Training step: registration prior, RP_Net forward, loss, optimizer update.

The counterpart of ``rpnet_tpu/train/trainer.py:46-218``:
  * optimizer block from the YAML (example.yml:62-73): ``Adam`` with
    ``weight_decay`` is optax's ``adamw``, i.e. decoupled decay —
    ``torch.optim.AdamW``; ``sgd`` is ``add_decayed_weights`` then momentum
    SGD — ``torch.optim.SGD(weight_decay, momentum)``;
  * the learning rate decays ×0.1 every ``scheduler_step`` epochs, staircase,
    counted in updates (``scheduler_step × steps_per_epoch``), as optax's
    ``exponential_decay`` over the update count;
  * loss: the registry's ``loss`` (default dice_ce) on the last refinement
    logits — or, with ``deep_supervision``, on every iteration's, ``equal``
    or ``linear`` weights — plus ``align_loss_scaler`` × the align loss;
  * the registration prior (affine fit, then with ``do_deformable`` the
    demons fit in the ``reg_sampler`` structure; no gradient) comes first,
    as in the JAX step; ``use_registration_loss: False`` feeds the raw
    support. The port's fit samples with ``F.grid_sample``, the values of
    the JAX fit's ``reg_sampler: gather``; its default ``matmul`` form
    agrees to the Dice level (ROADMAP.md).

The JAX step vmaps one episode's loss over E episodes. Here the E episodes
are folded into the slice axis of one forward (the correlation kernels
launch once per CRE call for all of them); everything that reduces over
slices reduces per episode — batch norm statistics (``models/blocks.py``),
the align loss's query prototypes (``models/rpnet.py``) and the
segmentation loss (here) — and the batch loss is the mean over episodes.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from rpnet_tpu_torch.models.losses import make_seg_loss
from rpnet_tpu_torch.registration.fit import register_episode


def lr_schedule(config, steps_per_epoch: int = 1) -> Callable[[int], float]:
    """The learning rate of update ``n`` (0-based): ``init_lr`` × 0.1 per
    ``scheduler_step`` epochs of ``steps_per_epoch`` updates; constant when
    ``scheduler_step`` is 0 or unset."""
    init_lr = float(config.get("init_lr", 1e-5))
    step_epochs = int(config.get("scheduler_step", 30) or 0)
    period = step_epochs * max(int(steps_per_epoch), 1)
    if step_epochs <= 0:
        return lambda n: init_lr
    return lambda n: init_lr * 0.1 ** (n // period)


def make_optimizer(params, config, steps_per_epoch: int = 1) -> torch.optim.Optimizer:
    """The YAML's optimizer over ``params``; its ``schedule`` attribute is
    :func:`lr_schedule`, applied by the train step before each update."""
    schedule = lr_schedule(config, steps_per_epoch)
    wd = float(config.get("weight_decay", 0.0))
    name = str(config.get("optimizer", "Adam")).lower()
    if name == "adam":
        opt = torch.optim.AdamW(params, lr=schedule(0), betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=wd)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=schedule(0), weight_decay=wd,
                              momentum=float(config.get("momentum", 0.9)))
    else:
        raise NotImplementedError(name)
    opt.schedule = schedule
    return opt


def fast_forward_optimizer(optimizer: torch.optim.Optimizer, n_updates: int) -> None:
    """Resume the update count of a fresh optimizer at ``n_updates``, as
    ``fast_forward_opt_state`` does (``rpnet_tpu/train/trainer.py:75-93``):
    Adam's bias correction continues from there with zero moments. The
    schedule position is the train state's ``step``."""
    if isinstance(optimizer, torch.optim.AdamW):
        for group in optimizer.param_groups:
            for p in group["params"]:
                optimizer.state[p] = {
                    "step": torch.tensor(float(n_updates)),
                    "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                    "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
                }


def check_ported(config) -> None:
    mfm = config.get("mask_feature_map", "no")
    for key, val, ok in (("backbone", config.get("backbone", "UNet"), "UNet"),
                         ("mask_feature_map", "no" if mfm is False else mfm, "no"),
                         ("use_relation_enc", config.get("use_relation_enc", "relation"),
                          "relation")):
        if val != ok:
            raise NotImplementedError(
                f"{key}: {val!r} training is not ported to rpnet_tpu_torch yet "
                f"(eval only; training takes {ok!r}; ROADMAP.md queue 1 item 3)")
    if int(config.get("n_way", 1)) > 1:
        raise NotImplementedError("n_way > 1 training is not ported to "
                                  "rpnet_tpu_torch yet (ROADMAP.md)")
    if (config.get("compute_dtype") or "float32") != "float32":
        raise NotImplementedError(f"compute_dtype {config.get('compute_dtype')!r} "
                                  "training is not ported yet (float32 only)")


def make_train_step(model, config, optimizer) -> Callable:
    """The train step ``step(state, batch) → metrics``.

    ``state`` is ``{"step": updates done}``, advanced in place. ``batch`` is
    four tensors on the model's device: supp_img, supp_lab (E, Sh, k, H, W)
    and qry_img, qry_lab (E, k, H, W); labels may be uint8. Metrics are
    0-d tensors: loss, seg_loss and align_loss, each the mean over episodes.
    """
    check_ported(config)
    affine_iters = int(config.get("reg_affine_iters", 50))
    demons_iters = (int(config.get("reg_demons_iters", 50))
                    if config.get("do_deformable", False) else 0)
    reg_sigma = float(config.get("reg_sigma", 2.0))
    reg_sampler = str(config.get("reg_sampler", "matmul"))
    fit_scale = int(config.get("reg_fit_scale", 1))
    reg_lr = float(config.get("reg_lr", 0.01))
    align_scaler = float(config.get("align_loss_scaler", 1.0))
    use_registration = bool(config.get("use_registration_loss", True))
    deep_supervision = bool(config.get("deep_supervision", False))
    ds_weights = str(config.get("deep_supervision_weights", "equal"))
    seg_loss = make_seg_loss(config.get("loss", "dice_ce"))

    def prior(supp_img, supp_lab, qry_img):
        """(registration prior, network support image, its label), shot 0."""
        if not use_registration:
            return supp_lab[:, 0], supp_img[:, 0], supp_lab[:, 0]
        E, _, k, H, W = supp_img.shape
        reg = register_episode(supp_img[:, 0].reshape(E * k, H, W),
                               qry_img.reshape(E * k, H, W),
                               supp_lab[:, 0].reshape(E * k, H, W),
                               affine_iters=affine_iters, demons_iters=demons_iters,
                               lr=reg_lr, sigma=reg_sigma, fit_scale=fit_scale,
                               sampler=reg_sampler)
        return tuple(a.reshape(E, k, H, W) for a in
                     (reg.warped_label, reg.affine_src, reg.affine_label))

    def episode_losses(logits, labels):   # (E, k, H, W, C), (E, k, H, W) → (E,)
        return torch.stack([seg_loss(lg, lb) for lg, lb in zip(logits, labels)])

    def train_step(state: Dict, batch) -> Dict[str, torch.Tensor]:
        supp_img, supp_lab, qry_img, qry_lab = batch
        supp_lab = supp_lab.to(supp_img.dtype)   # uint8 {0, 1} labels widen exactly
        qry_lab = qry_lab.to(supp_img.dtype)
        with torch.no_grad():
            appr, supp_in, fore = prior(supp_img, supp_lab, qry_img)

        model.train()
        supp_t = supp_in[:, None, None, ..., None]        # (E, 1, 1, k, H, W, 1)
        fore_t = fore[:, None, None]
        out = model(supp_t, fore_t, 1.0 - fore_t, qry_img[..., None], appr)
        if deep_supervision:
            # every refinement iteration supervised (mean or linear weights)
            per_iter = torch.stack([episode_losses(lg, qry_lab)
                                    for lg in out["refinement"]])   # (T, E)
            T = per_iter.shape[0]
            if ds_weights == "linear":
                w = torch.arange(1, T + 1, dtype=per_iter.dtype, device=per_iter.device)
                seg = torch.sum(per_iter * (w / w.sum())[:, None], dim=0)
            else:
                seg = per_iter.mean(dim=0)
        else:
            seg = episode_losses(out["output"], qry_lab)
        loss = torch.mean(seg + align_scaler * out["align_loss"])

        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for group in optimizer.param_groups:
            group["lr"] = optimizer.schedule(state["step"])
        optimizer.step()
        state["step"] += 1
        return {"loss": loss.detach(), "seg_loss": seg.mean().detach(),
                "align_loss": out["align_loss"].mean().detach()}

    return train_step
