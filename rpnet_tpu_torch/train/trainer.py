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
    agrees to the Dice level (ROADMAP.md);
  * ``n_way`` > 1 tiles the support and its mask over the ways
    (``rpnet_tpu/train/trainer.py:149-155``): 1 + n_way output channels, the
    eval layout;
  * ``compute_dtype`` below f32 (bfloat16, float16) keeps the f32
    parameters as the master copy and rounds them to that dtype for each
    step's forward through a differentiable cast, and the batch norms'
    running statistics where each one's first update of the step reads them
    (``trainer.py:156-162``, ``models/blocks.py``); activations stay f32, so
    every convolution and the correlation compute in f32 with rounded
    weights, as flax's promoting ``nn.Conv``/``nn.BatchNorm`` do. Gradients
    come back through the cast (rounded to the dtype, then widened).

The JAX step vmaps one episode's loss over E episodes. Here the E episodes
are folded into the slice axis of one forward (the correlation kernels
launch once per CRE call for all of them); everything that reduces over
slices reduces per episode — batch norm statistics (``models/blocks.py``),
the align loss's query prototypes (``models/rpnet.py``) and the
segmentation loss (here) — and the batch loss is the mean over episodes.

:func:`sharded_train_step` is the JAX package's ``sharded_train_step``
over a ``parallel/mesh.LocalMesh``: the episodes split over ``data``, the
wide convs' output channels over ``model`` (its docstring).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from rpnet_tpu_torch.models.blocks import cast_statistics
from rpnet_tpu_torch.models.losses import make_seg_loss
from rpnet_tpu_torch.registration.fit import register_episode
from rpnet_tpu_torch.utils.profiling import span


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


def make_train_step(model, config, optimizer) -> Callable:
    """The train step ``step(state, batch) → metrics``.

    ``state`` is ``{"step": updates done}``, advanced in place. ``batch`` is
    four tensors on the model's device: supp_img, supp_lab (E, Sh, k, H, W)
    and qry_img, qry_lab (E, k, H, W); labels may be uint8. Metrics are
    0-d tensors: loss, seg_loss and align_loss, each the mean over episodes.
    """
    compute_dtype = getattr(torch, str(config.get("compute_dtype") or "float32"))
    rounded = compute_dtype.itemsize < 4
    episode_losses = make_episode_losses(config)

    def forward(*args):
        """The training forward; below f32 each f32 parameter rounded to
        ``compute_dtype`` through a differentiable cast, and the running
        statistics as the step's first update of each reads them."""
        if not rounded:
            return model(*args)
        cast_statistics(model, compute_dtype)
        params = {n: p.to(compute_dtype).to(p.dtype) if p.dtype == torch.float32 else p
                  for n, p in model.named_parameters()}
        return torch.func.functional_call(model, params, args)

    @span("train.step")
    def train_step(state: Dict, batch) -> Dict[str, torch.Tensor]:
        model.train()
        seg, align = episode_losses(forward, *batch)
        return _update(optimizer, state, seg, align, float(config.get("align_loss_scaler", 1.0)))

    return train_step


def make_episode_losses(config) -> Callable:
    """``losses(forward, supp_img, supp_lab, qry_img, qry_lab)`` → (seg,
    align), each (E,): the registration prior (no gradient), the network
    through ``forward`` (the model's training forward) and each episode's
    segmentation and align losses."""
    affine_iters = int(config.get("reg_affine_iters", 50))
    demons_iters = (int(config.get("reg_demons_iters", 50))
                    if config.get("do_deformable", False) else 0)
    reg_sigma = float(config.get("reg_sigma", 2.0))
    reg_sampler = str(config.get("reg_sampler", "matmul"))
    fit_scale = int(config.get("reg_fit_scale", 1))
    reg_lr = float(config.get("reg_lr", 0.01))
    use_registration = bool(config.get("use_registration_loss", True))
    deep_supervision = bool(config.get("deep_supervision", False))
    ds_weights = str(config.get("deep_supervision_weights", "equal"))
    seg_loss = make_seg_loss(config.get("loss", "dice_ce"))
    n_way = int(config.get("n_way", 1))

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

    def losses(forward, supp_img, supp_lab, qry_img, qry_lab):
        supp_lab = supp_lab.to(supp_img.dtype)   # uint8 {0, 1} labels widen exactly
        qry_lab = qry_lab.to(supp_img.dtype)
        with torch.no_grad():
            appr, supp_in, fore = prior(supp_img, supp_lab, qry_img)

        supp_t = supp_in[:, None, None, ..., None]        # (E, 1, 1, k, H, W, 1)
        fore_t = fore[:, None, None]
        if n_way > 1:   # the support tiled over the ways: (E, n_way, 1, k, ...)
            supp_t = supp_t.expand(-1, n_way, *supp_t.shape[2:])
            fore_t = fore_t.expand(-1, n_way, *fore_t.shape[2:])
        out = forward(supp_t, fore_t, 1.0 - fore_t, qry_img[..., None], appr)
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
        return seg, out["align_loss"]

    return losses


def _update(optimizer, state: Dict, seg, align, align_scaler: float) -> Dict[str, torch.Tensor]:
    """The batch loss (the mean over episodes of seg + align_scaler ×
    align), its backward and one optimizer step at the schedule's rate."""
    loss = torch.mean(seg + align_scaler * align)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    for group in optimizer.param_groups:
        group["lr"] = optimizer.schedule(state["step"])
    optimizer.step()
    state["step"] += 1
    return {"loss": loss.detach(), "seg_loss": seg.mean().detach(),
            "align_loss": align.mean().detach()}


def sharded_train_step(model, config, optimizer, mesh) -> Callable:
    """The train step over ``mesh`` (``rpnet_tpu/train/trainer.py:249-284``):
    ``step(state, batch) → metrics`` as :func:`make_train_step`'s, the
    batch anywhere, the metrics on the mesh's first device.

    * ``data``: the E episodes split over the rows (E divisible by the
      axis); each row's first device runs the prior, the forward and the
      losses of its episodes, with every replicated parameter copied there
      (a differentiable copy, none on the first device). Batch norm
      statistics stay per episode; each row updates its own copy of the
      running statistics, and the new ones are the mean over all episodes
      (the update is linear in the batch statistics, so this is the
      one-device step's). The loss is the sum of the rows' episode losses
      over E, so the backward averages the gradients over the shards.
    * ``model``: each conv weight that :func:`~rpnet_tpu_torch.parallel.
      mesh.param_sharding_rule` picks (OIHW output channels ≥ 256 and
      divisible by the axis) is split into row-slices, slice j a leaf on
      device j of the first row; the optimizer updates the slices (its
      state for the weight split with them). In a row, slice j's output
      channels are computed on the row's device j and concatenated on the
      row's first device (``models/blocks.Conv2d.tp``). After each update
      the slices are written back into the model's weight, so the model
      (its ``state_dict``, a checkpoint, eval) holds the trained values.

    ``model`` lives on ``mesh.first``; ``optimizer`` is the one over its
    parameters, which this call reshapes for the split weights."""
    from rpnet_tpu_torch.models.blocks import Conv2d
    from rpnet_tpu_torch.parallel.mesh import shard_params, shard_slices

    home = torch.device(mesh.first)
    if next(model.parameters()).device != home:
        raise ValueError(f"the model lives on {next(model.parameters()).device}; "
                         f"the sharded step keeps it on the mesh's first device {home}")
    compute_dtype = getattr(torch, str(config.get("compute_dtype") or "float32"))
    rounded = compute_dtype.itemsize < 4
    rnd = lambda t: t.to(compute_dtype).to(t.dtype) if rounded and t.dtype == torch.float32 else t
    episode_losses = make_episode_losses(config)
    align_scaler = float(config.get("align_loss_scaler", 1.0))
    n_data, n_model = mesh.shape["data"], mesh.shape["model"]

    placement = shard_params(model, mesh)
    modules = dict(model.named_modules())
    split: Dict[str, tuple] = {}         # conv name → (module, master slices)
    for name, where in placement.items():
        if where != "model":
            continue
        conv = modules[name.rsplit(".", 1)[0]]
        if not isinstance(conv, Conv2d):
            raise NotImplementedError(f"{name}: the tensor-parallel split takes "
                                      "models/blocks.Conv2d weights")
        slices = [torch.nn.Parameter(w.detach().to(d, copy=True))
                  for w, d in zip(conv.weight.chunk(n_model), mesh.rows[0])]
        _split_in_optimizer(optimizer, conv.weight, slices)
        split[name.rsplit(".", 1)[0]] = (conv, slices)
    replicated_params = [(n, p) for n, p in model.named_parameters()
                         if n.rsplit(".", 1)[0] not in split or not n.endswith("weight")]

    def row_forward(i: int, dev):
        """Row ``i``'s forward on ``dev`` and its copy of the buffers."""
        params = {n: rnd(p.to(dev)) for n, p in replicated_params}
        buffers = {n: b.to(dev, copy=True) for n, b in model.named_buffers()}
        for conv, slices in split.values():
            conv.tp = [(d, rnd(s.to(d))) for s, d in zip(slices, mesh.rows[i])]
        if rounded:
            cast_statistics(model, compute_dtype)
        return (lambda *args: torch.func.functional_call(model, {**params, **buffers}, args),
                buffers)

    @span("train.step")
    def train_step(state: Dict, batch) -> Dict[str, torch.Tensor]:
        E = batch[0].shape[0]
        if E % n_data:
            raise ValueError(f"{E} episodes do not split over a data axis of {n_data}")
        rows = list(zip(*(shard_slices(mesh, t) for t in batch)))
        model.train()
        segs, aligns, row_buffers = [], [], []
        try:
            for i, (row, dev) in enumerate(zip(rows, mesh.data_devices)):
                forward, buffers = row_forward(i, torch.device(dev))
                seg, align = episode_losses(forward, *row)
                segs.append(seg.to(home))
                aligns.append(align.to(home))
                row_buffers.append(buffers)
        finally:
            for conv, _ in split.values():
                conv.tp = None
        with torch.no_grad():
            for n, b in model.named_buffers():
                parts = [rb[n].to(home) for rb in row_buffers]
                b.copy_(torch.stack(parts).mean(0) if b.is_floating_point() else parts[0])
        metrics = _update(optimizer, state, torch.cat(segs), torch.cat(aligns), align_scaler)
        with torch.no_grad():
            for conv, slices in split.values():
                conv.weight.copy_(torch.cat([s.to(home) for s in slices]))
        return metrics

    return train_step


def _split_in_optimizer(optimizer: torch.optim.Optimizer, weight: torch.Tensor,
                        slices) -> None:
    """Put ``slices`` (row-slices of ``weight``) in ``weight``'s place in the
    optimizer, each with its rows of the weight's state (moments) on its
    device."""
    n = len(slices)
    for group in optimizer.param_groups:
        group["params"] = [q for p in group["params"]
                           for q in (slices if p is weight else [p])]
    state = optimizer.state.pop(weight, None)
    if not state:
        return
    for j, s in enumerate(slices):
        optimizer.state[s] = {
            k: (v.chunk(n)[j].to(s.device, copy=True) if torch.is_tensor(v) and v.dim()
                and v.shape == weight.shape else v.clone() if torch.is_tensor(v) else v)
            for k, v in state.items()}
