"""RP_Net training: ``train/trainer.make_train_step`` fed as the train CLI's
``train`` feeds it. Each epoch shuffles the (volume, organ) episodes with
stdlib ``random``; a batch is ``batch_size`` episodes from
``EpisodeSampler(mode="train").sample`` (supports drawn, query slices
drawn, gamma-jittered, warped and shuffled) collated by
``cli/train.collate_batch``, assembled and uploaded while the previous step
runs; reading that step's loss is the wait.

Set-up builds the model and its optimizer once, loads the benchmark's
weights, and drives that same step through its first steps, one more than
it takes to visit every (volume, organ) pair, so that each sits in the
sampler's LRU. The check compares the three first batches with the
reference's replay of the same draws, the three first steps' registration
priors with the reference's registration, and the three first steps'
losses, the first gradient (AdamW's first moment after one step) and the
parameters' change after three steps with the plain reference's three
steps (network from the program's registration outputs, dice +
cross-entropy and align loss, AdamW).
The window then runs steps until ``--seconds`` have passed;
``train_step_ms`` is its length over the steps it completed.
"""

from __future__ import annotations

import contextlib
import gc
import os
import random
import time

import numpy as np
import torch

import harness
import roofline
import weights
from reference import precision
from reference import rpnet as ref
from reference.optim import adamw_step
from training_check import Steps, compare
from traffic.volumes import make_volume, write_dataset

CHECKED_STEPS = 3


def collate(episodes, k: int):
    """Episodes stacked on a leading axis, each cycled through its slices
    to ``k`` where its organ gave fewer."""
    def cyc(a, axis):
        return np.take(a, np.arange(k) % a.shape[axis], axis=axis)
    return [np.stack([cyc(e[i], 1 if i < 2 else 0) for e in episodes]) for i in range(4)]


class Cell:
    def __init__(self, run: harness.Run):
        self.run = run
        self.log = open(os.path.join(run.workdir, "program.log"), "w")
        self.losses, self.kept, self.pending = [], [], None
        self.order, self.at = [], 0
        self.first = {}            # the first step's encoder outputs
        self.inputs = []           # the checked steps' network inputs (the registration's outputs)

    def setup(self):
        from rpnet_tpu_torch.config import Config
        from rpnet_tpu_torch.episode.sampler import EpisodeSampler
        from rpnet_tpu_torch.models.factory import build_rpnet
        from rpnet_tpu_torch.train.trainer import make_optimizer, make_train_step

        run, tr = self.run, self.run.traffic
        s = harness.seeds(run.seed)
        gen = torch.Generator(device=run.device).manual_seed(s["torch"])
        rng = np.random.RandomState(s["numpy"])
        rois = list(run.config["train_classes"])
        extents = {roi: [int(e) for e in rng.permutation(tr["extents"][roi])] for roi in rois}
        vols = []
        for i in range(len(extents[rois[0]])):
            ct, masks = make_volume(tuple(tr["volume_shape"]), rois,
                                    {roi: extents[roi][i] for roi in rois}, gen, run.device)
            vols.append((f"r{i:02d}", ct.cpu().numpy(), {k: m.cpu().numpy() for k, m in masks.items()}))
        self.volumes = {pid: (ct, m) for pid, ct, m in vols}
        paths = write_dataset(os.path.join(run.workdir, "data"), vols,
                              {"train": [v[0] for v in vols]}, rois)
        keys = harness.program_keys(run.config)
        keys.update(tr.get("program", {}))
        keys.update(data_dir=paths["data_dir"], class_csv_dir=paths["class_csv_dir"],
                    train_set_name=paths["train_csv"])
        self.config = cfg = Config(keys)
        with contextlib.redirect_stdout(self.log):
            self.sampler = EpisodeSampler(cfg["data_dir"], cfg["train_set_name"], cfg, mode="train")
            model = build_rpnet(cfg, num_iter=cfg["n_iter_refinement"], seed=0,
                                device=run.device, align=True)
        self.sd = weights.draw(weights.template_of(model), gen, run.device)
        model.load_state_dict(self.sd)
        self.steps_per_epoch = max(1, -(-len(self.sampler) // int(cfg["batch_size"])))
        self.optimizer = make_optimizer(model.parameters(), cfg, self.steps_per_epoch)
        self.model, self.names = model, [n for n, _ in model.named_parameters()]
        self.step = make_train_step(model, cfg, self.optimizer)
        self.state = {"step": 0}
        self.s = s
        # the CLI's streams, seeded where its loop starts drawing
        np.random.seed(s["numpy"])
        random.seed(s["random"])
        def keep_inputs(module, args, output):
            self.inputs.append([x.detach().clone() for x in args])

        def keep_features(module, args, output):
            self.first.setdefault("features", []).append(output.detach().clone())

        hooks = [model.register_forward_hook(keep_inputs),
                 model.encoder.register_forward_hook(keep_features)]
        self._steps(1, keep=True)
        hooks.pop().remove()
        b1 = self.optimizer.param_groups[0]["betas"][0]
        # the first moment after one step (none where the step updated nothing)
        self.g1 = {n: self.optimizer.state[p]["exp_avg"].detach() / (1 - b1)
                   if "exp_avg" in self.optimizer.state.get(p, {}) else torch.zeros_like(p)
                   for n, p in model.named_parameters()}
        self._steps(CHECKED_STEPS - 1, keep=True)
        hooks.pop().remove()
        self.theta3 = {n: p.detach().clone() for n, p in model.named_parameters()}
        self._steps(self.steps_per_epoch + 1 - CHECKED_STEPS)
        self._drain()
        run.attempted = run.failed = 0

    def _next_batch(self):
        """The next ``batch_size`` episodes of the epoch's shuffled order
        (a new shuffle at each epoch), collated as the CLI collates them."""
        from rpnet_tpu_torch.cli.train import collate_batch

        cfg = self.config
        bs = int(cfg["batch_size"])
        if not self.order:
            self.order = list(range(len(self.sampler)))
            self.at = len(self.order)
        if self.at >= len(self.order):          # an epoch starts: the CLI's in-place shuffle
            random.shuffle(self.order)
            self.at = 0
        take = [self.order[(self.at + j) % len(self.order)] for j in range(bs)]
        self.at += bs
        episodes = [self.sampler.sample(t) for t in take]
        return collate_batch(episodes, target_k=int(cfg["k"])), take

    def _steps(self, n: int, keep: bool = False) -> None:
        spans, dev = self.run.spans, self.run.device
        for _ in range(n):
            with spans("batch"):
                batch, take = self._next_batch()
            if keep:
                self.kept.append((batch, take))
            self._drain()
            self.pending = self.step(self.state, tuple(torch.from_numpy(a).to(dev, non_blocking=True)
                                                       for a in batch))
            self.run.attempted += 1

    def _drain(self) -> None:
        if self.pending is not None:
            loss = float(self.pending["loss"])
            self.losses.append(loss)
            self.run.failed += 0 if np.isfinite(loss) else 1
            self.pending = None

    def window(self):
        run = self.run
        if run.trace:
            steps = int(run.traffic["trace_steps"])
            harness.traced_work(run, lambda: (self._steps(steps), self._drain()))
            self._count_work(steps)
            return
        t0 = time.perf_counter()
        while True:
            self._steps(1)
            if time.perf_counter() - t0 >= run.seconds:
                break
        self._drain()
        run.metrics["train_step_ms"] = (time.perf_counter() - t0) * 1e3 / run.attempted

    def _count_work(self, steps: int):
        """Forward and backward FLOPs of the traced steps (the reference's
        convolutions and products, the correlation's products; the
        registration not counted) and their correlation calls."""
        run, cfg = self.run, self.config
        supp = self.kept[0][0][0]
        E, _, k, H, W = supp.shape
        T, r, sc = int(cfg["n_iter_refinement"]), int(cfg["mask_refinement_correlation_radius"]), int(cfg["scale"])
        p = {n: torch.empty(v.shape, device="meta", requires_grad=n in self.names)
             for n, v in self.sd.items() if v.is_floating_point()}
        x = torch.empty((E * k, H, W), device="meta")

        def fwd_bwd():
            out = ref.rpnet(p, x, x, x, x, x, T, r, sc, train=True, episodes=E)
            (out["refinement"].sum() + ref.align_loss(out, x, x, E).sum()).backward()

        shape = (E * k, H // sc, W // sc, 256)
        per_step = roofline.counted_flops(fwd_bwd) + (1 + T) * (
            roofline.corr_products(shape, r) + roofline.corr_products(shape, r, backward=True))
        run.work_flops = steps * per_step
        run.peak_unit = roofline.UNIT_OF_DTYPE["float32"]
        run.corr_calls = steps * (1 + T) * [(shape, r, "float32", False), (shape, r, "float32", True)]

    # ------------------------------------------------------------- check
    def _replayed_batches(self):
        """The first batches as the reference draws them: the same seeds,
        the same order of draws, the reader's preparation of each volume."""
        cfg = self.config
        random.seed(self.s["random"])
        np.random.seed(self.s["numpy"])
        rois = list(cfg["train_classes"])
        pids = sorted(self.volumes)
        pairs = [(ci, di) for ci in range(len(rois)) for di in range(len(pids))]
        order, prepared, batches = list(range(len(pairs))), {}, []
        at = len(order)

        def prep(pid, roi):
            if (pid, roi) not in prepared:
                ct, masks = self.volumes[pid]
                prepared[(pid, roi)] = ref.preprocess(ct, masks[roi], cfg)
            return prepared[(pid, roi)]

        bs = int(cfg["batch_size"])
        for _ in range(CHECKED_STEPS):
            if at >= len(order):
                random.shuffle(order)
                at = 0
            eps = []
            for t in [order[(at + j) % len(order)] for j in range(bs)]:
                ci, di = pairs[t]
                pool = [i for i in range(len(pids)) if i != di]
                pick = random.choices(pool, k=int(cfg["n_shot"]))[-1]
                eps.append(ref.train_episode(prep(pids[pick], rois[ci]), prep(pids[di], rois[ci]), cfg))
            at += bs
            batches.append(collate(eps, int(cfg["k"])))
        return batches

    def _register(self, batches, quant=None):
        """The reference's registration of each checked batch → (support
        image, its label, prior) a step, each (E·k, H, W). With ``quant``
        its warps are rounded by it."""
        cfg, dev, regs = self.config, self.run.device, []
        with torch.no_grad():
            for batch in batches:
                supp, slab, qry, _ = (torch.from_numpy(np.asarray(a, np.float32)).to(dev)
                                      for a in batch)
                E, _, k, H, W = supp.shape
                reg = ref.register(supp[:, 0].reshape(E * k, H, W), qry.reshape(E * k, H, W),
                                   slab[:, 0].reshape(E * k, H, W), int(cfg["reg_affine_iters"]),
                                   float(cfg["reg_lr"]), int(cfg["reg_fit_scale"]), quant=quant)
                regs.append((reg["affine_src"], reg["affine_label"], reg["prior"]))
        return regs

    def _program_registration(self):
        """The program's registration outputs, as its checked steps fed
        them to the network, in the form of :meth:`_register`."""
        regs = []
        for supp_t, fore_t, _, _, appr in self.inputs:
            H, W = fore_t.shape[-2:]
            regs.append(tuple(a.float().reshape(-1, H, W) for a in (supp_t, fore_t, appr)))
        return regs

    def _reference(self, batches, regs, quant=None, fault=None) -> Steps:
        """The reference's three steps from the benchmark's weights, its
        network fed the registration outputs ``regs`` (the program's, or
        the control's own; the registration is checked on its own) →
        (losses, first gradients, parameters after three). ``fault`` plants
        one in it: ``half`` takes the loss over the first half of the
        episodes only, ``unchanged`` never updates."""
        cfg, dev = self.config, self.run.device
        T, r, sc = int(cfg["n_iter_refinement"]), int(cfg["mask_refinement_correlation_radius"]), int(cfg["scale"])
        p = {n: self.sd[n].detach().clone().requires_grad_(True) for n in self.names}
        consts = {n: v for n, v in self.sd.items() if n not in p}
        state, losses, g1 = {}, [], None
        for t, (batch, (supp_in, fore, prior)) in enumerate(zip(batches, regs), 1):
            qry, qlab = (torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in batch[2:])
            E, k, H, W = qry.shape
            out = ref.rpnet({**consts, **p}, supp_in, fore, 1 - fore, qry.reshape(E * k, H, W),
                            prior, T, r, sc, quant=quant, train=True, episodes=E)
            last = out["refinement"][-1]
            seg = torch.stack([ref.dice_ce(last[e * k:(e + 1) * k], qlab[e]) for e in range(E)])
            per_ep = seg + float(cfg["align_loss_scaler"]) * ref.align_loss(out, fore, 1 - fore, E)
            loss = (per_ep[:E // 2] if fault == "half" else per_ep).mean()
            grads = dict(zip(self.names, torch.autograd.grad(loss, [p[n] for n in self.names])))
            losses.append(float(loss.detach()))
            if t == 1:
                g1 = {} if fault == "unchanged" else grads
            if fault != "unchanged":
                with torch.no_grad():
                    adamw_step(p, grads, state, float(cfg["init_lr"]), float(cfg["weight_decay"]), t)
            del out, grads, loss
        return Steps(losses, g1, {n: v.detach() for n, v in p.items()}, {})

    def _encoder(self, quant=None):
        """The reference's encoder passes (supports, then query, each batch
        norm on each episode's statistics) on the program's first network
        inputs (its registration outputs, checked by the losses)."""
        supp_t, _, _, qry, _ = self.inputs[0]
        E, H, W = supp_t.shape[0], supp_t.shape[-3], supp_t.shape[-2]
        with torch.no_grad():
            return {"feature": [ref.unet(x.reshape(-1, 1, H, W), self.sd, quant, True, E)
                                .permute(0, 2, 3, 1) for x in (supp_t, qry)]}

    def _free(self):
        self.model = self.optimizer = self.step = self.sampler = self.pending = None
        self.log.close()
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def check(self, control: bool = False):
        """Each compared number → (value, limit). With ``control`` the
        reference computed in bf16 (the configuration states f32) takes the
        program's place, its registration too."""
        limits = self.run.traffic["limits"]
        self._free()
        batches = self._replayed_batches()
        batch_gap = 0.0
        for (got, _), want in zip(self.kept, batches):
            for g, w in zip(got, want):
                batch_gap = max(batch_gap, float("inf") if g.shape != w.shape
                                else float(np.abs(g.astype(np.float32) - w).max()))
        with harness.full_f32():
            own = self._register(batches)
            if control:
                regs = self._register(batches, precision.bf16)
                got = self._reference(batches, regs, precision.bf16)._replace(
                    outputs=self._encoder(precision.bf16))
            else:
                regs = self._program_registration()
                got = Steps(self.losses[:CHECKED_STEPS], self.g1, self.theta3,
                            {"feature": self.first["features"]})
            want = self._reference(batches, regs)._replace(outputs=self._encoder())
        numbers, self.details = compare(self.names, self.sd, got, want)
        numbers["batch_gap"] = batch_gap
        numbers["prior_mismatch"] = max(
            float((a[2] != b[2]).float().mean()) if a[2].shape == b[2].shape else float("inf")
            for a, b in zip(regs, own))
        return {k: (numbers[k], limit) for k, limit in limits.items()}

    def fault_readings(self) -> dict:
        """Each number with each fault planted in the reference that takes
        the program's place."""
        self._free()
        batches = self._replayed_batches()
        with harness.full_f32():
            regs = self._register(batches)
            want = self._reference(batches, regs)._replace(outputs=self._encoder())
            return {f: compare(self.names, self.sd, self._reference(batches, regs, fault=f)._replace(
                        outputs=want.outputs), want)[0] for f in ("half", "unchanged")}

    def witness_readings(self) -> dict:
        """Each number with the reference run at torch's default precision
        (cuDNN convolutions in TF32, as the program runs them) in the
        program's place: what rounding alone moves."""
        self._free()
        batches = self._replayed_batches()
        with harness.full_f32():
            regs = self._register(batches)
            want = self._reference(batches, regs)._replace(outputs=self._encoder())
        with harness.torch_defaults():
            got = self._reference(batches, regs)._replace(outputs=self._encoder())
        return compare(self.names, self.sd, got, want)[0]
