"""LGCANet_V3 training: ``train/lgca.make_lgca_train_step`` fed as the train
CLI's ``train_lgca`` feeds it. Volume j % n is sampled by the
``LGCAVolumeSampler`` in train mode (its slices drawn from a
``RandomState`` of the seed) and uploaded while step j − 1 runs; reading a
step's loss is the wait.

Set-up builds the model and its optimizer once, loads the benchmark's
weights, and drives that same step through its first four steps (every
volume then sits in the sampler's LRU): the check compares the three first
steps' batches, losses, the first gradient (from AdamW's first moment after
one step) and the parameters' change after three steps with the plain
reference following the same three steps. The window then runs steps until
``--seconds`` have passed; ``train_step_ms`` is its length over the steps
it completed.
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
from reference import lgca as ref
from reference import precision
from reference.optim import adamw_step
from training_check import Steps, compare
from traffic.volumes import make_volume, write_dataset

BATCH_KEYS = ("volume", "slices", "mask", "downsampled_volume_mask")
CHECKED_STEPS = 3


class Cell:
    def __init__(self, run: harness.Run):
        self.run = run
        self.log = open(os.path.join(run.workdir, "program.log"), "w")
        self.losses, self.kept, self.pending, self.j = [], [], None, 0
        self.outputs = None        # the first step's forward outputs, by name

    def setup(self):
        from rpnet_tpu_torch.config import Config
        from rpnet_tpu_torch.episode.lgca_data import LGCAVolumeSampler
        from rpnet_tpu_torch.train.lgca import init_lgca, make_lgca_train_step

        run, tr = self.run, self.run.traffic
        s = harness.seeds(run.seed)
        gen = torch.Generator(device=run.device).manual_seed(s["torch"])
        rois = list(run.config["roi_names"])
        vols = []
        for i in range(int(tr["volumes"])):
            ct, masks = make_volume(tuple(tr["volume_shape"]), rois, None, gen, run.device)
            vols.append((f"t{i:02d}", ct.cpu().numpy(), {k: m.cpu().numpy() for k, m in masks.items()}))
        self.volumes = {pid: (ct, m) for pid, ct, m in vols}
        self.pids = [v[0] for v in vols]
        paths = write_dataset(os.path.join(run.workdir, "data"), vols, {"train": self.pids}, rois)
        keys = harness.program_keys(run.config)
        keys.update(data_dir=paths["data_dir"], train_set_name=paths["train_csv"])
        self.config = Config(keys)
        np.random.seed(s["numpy"])
        random.seed(s["random"])
        with contextlib.redirect_stdout(self.log):
            self.sampler = LGCAVolumeSampler(paths["data_dir"], paths["train_csv"], self.config,
                                             mode="train")
            model, self.optimizer, self.state = init_lgca(self.config, 0, run.device,
                                                          len(self.sampler))
        self.sd = weights.draw(weights.template_of(model), gen, run.device)
        model.load_state_dict(self.sd)
        self.model = model
        self.names = [n for n, _ in model.named_parameters()]
        self.step = make_lgca_train_step(model, self.optimizer)
        self.rng = np.random.RandomState(s["numpy"])
        self.s = s
        hook = model.register_forward_hook(
            lambda m, a, out: setattr(self, "outputs", self.outputs or {
                "seg": [out["seg_2d"].detach().clone()], "dsv": [out["dsv"].detach().clone()]}))
        self._steps(1, keep=True)
        hook.remove()
        b1 = self.optimizer.param_groups[0]["betas"][0]
        # the first moment after one step (none where the step updated nothing)
        self.g1 = {n: self.optimizer.state[p]["exp_avg"].detach() / (1 - b1)
                   if "exp_avg" in self.optimizer.state.get(p, {}) else torch.zeros_like(p)
                   for n, p in model.named_parameters()}
        self._steps(CHECKED_STEPS - 1, keep=True)
        self.theta3 = {n: p.detach().clone() for n, p in model.named_parameters()}
        self._steps(int(tr["volumes"]) + 1 - CHECKED_STEPS)    # every volume in the LRU
        self._drain()
        run.attempted = run.failed = 0

    def _steps(self, n: int, keep: bool = False) -> None:
        """``n`` steps as the CLI runs them: sample and upload the next
        volume, then wait for the previous step's loss, then queue the step."""
        spans, dev = self.run.spans, self.run.device
        for _ in range(n):
            with spans("batch"):
                sample = self.sampler.sample(self.j % len(self.sampler), rng=self.rng)
                batch = tuple(torch.from_numpy(sample[k]).to(dev, non_blocking=True)
                              for k in BATCH_KEYS)
            if keep:
                self.kept.append(sample)
            self._drain()
            self.pending = self.step(self.state, batch)
            self.run.attempted += 1
            self.j += 1

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
            run.work_flops = steps * self._step_flops()
            run.peak_unit = roofline.UNIT_OF_DTYPE["float32"]
            return
        t0 = time.perf_counter()
        while True:
            self._steps(1)
            if time.perf_counter() - t0 >= run.seconds:
                break
        self._drain()
        run.metrics["train_step_ms"] = (time.perf_counter() - t0) * 1e3 / run.attempted

    def _step_flops(self) -> float:
        """Forward and backward FLOPs of one step, counted on the reference."""
        s = self.kept[0]
        meta = lambda a: torch.empty(a.shape, device="meta")
        p = {n: torch.empty(v.shape, device="meta", requires_grad=n in self.names)
             for n, v in self.sd.items() if v.is_floating_point()}
        vol = meta(s["volume"]).permute(0, 4, 1, 2, 3)
        sl = meta(s["slices"]).permute(0, 3, 1, 2)

        def fwd_bwd():
            out = ref.lgca(p, vol, sl, train=True)
            ref.loss(out, meta(s["mask"]), meta(s["downsampled_volume_mask"])).backward()

        return roofline.counted_flops(fwd_bwd)

    # ------------------------------------------------------------- check
    def _reference(self, quant=None, fault=None) -> Steps:
        """The reference's three steps from the benchmark's weights on the
        kept batches. ``fault`` plants one in it: ``half`` takes the loss
        over the first half of the slices only, ``unchanged`` never updates."""
        cfg, dev = self.config, self.run.device
        p = {n: self.sd[n].detach().clone().requires_grad_(True) for n in self.names}
        consts = {n: v for n, v in self.sd.items() if n not in p}
        state, losses, g1, outputs = {}, [], None, None
        for t, sample in enumerate(self.kept, 1):
            b = {k: torch.from_numpy(sample[k]).to(dev) for k in BATCH_KEYS}
            out = ref.lgca({**consts, **p}, b["volume"].permute(0, 4, 1, 2, 3),
                           b["slices"].permute(0, 3, 1, 2), quant=quant, train=True)
            n = b["mask"].shape[0] // 2 if fault == "half" else b["mask"].shape[0]
            loss = ref.loss({"seg_2d": out["seg_2d"][:n], "dsv": out["dsv"]}, b["mask"][:n],
                            b["downsampled_volume_mask"])
            grads = dict(zip(self.names, torch.autograd.grad(loss, [p[n] for n in self.names])))
            losses.append(float(loss.detach()))
            if t == 1:
                g1 = {} if fault == "unchanged" else grads
                outputs = {"seg": [out["seg_2d"].detach().permute(0, 2, 3, 1)],
                           "dsv": [out["dsv"].detach().permute(0, 2, 3, 4, 1)]}
            if fault != "unchanged":
                with torch.no_grad():
                    adamw_step(p, grads, state, float(cfg["init_lr"]),
                               float(cfg["weight_decay"]), t)
            del out, grads, loss
        return Steps(losses, g1, {n: v.detach() for n, v in p.items()}, outputs)

    def _batches_gap(self) -> float:
        """Largest difference between the batches the sampler gave and the
        reference's preparation of the same volumes and slice draws."""
        cfg = self.config
        rng = np.random.RandomState(self.s["numpy"])
        prepared, gap = {}, 0.0
        for t, sample in enumerate(self.kept):
            pid = self.pids[t % len(self.pids)]
            if pid not in prepared:
                prepared[pid] = ref.prepare_volume(*self.volumes[pid], cfg)
            vol, masks = prepared[pid]
            z = ref.draw_slices(masks, int(cfg["lgca_slices"]), rng)
            sz, sy, sx = cfg["context_net_downsample_scale"]
            want = {"volume": vol[::sz, ::sy, ::sx][None, ..., None],
                    "downsampled_volume_mask": masks[::sz, ::sy, ::sx][None],
                    "slices": vol[z][..., None], "mask": masks[z]}
            for k, v in want.items():
                got = sample[k]
                gap = max(gap, float("inf") if got.shape != v.shape
                          else float(np.abs(got - v).max()))
            gap = max(gap, 0.0 if np.array_equal(sample["slice_idx"], z) else float("inf"))
        return gap

    def _free(self):
        self.model = self.optimizer = self.step = self.sampler = self.pending = None
        self.log.close()
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def check(self, control: bool = False):
        """Each compared number → (value, limit). With ``control`` the
        reference computed in bf16 (the configuration states f32) takes the
        program's place."""
        limits = self.run.traffic["limits"]
        self._free()
        with harness.full_f32():
            want = self._reference()
            got = (self._reference(precision.bf16) if control else
                   Steps(self.losses[:CHECKED_STEPS], self.g1, self.theta3, self.outputs))
        numbers, self.details = compare(self.names, self.sd, got, want)
        numbers["batch_gap"] = self._batches_gap()
        return {k: (numbers[k], limit) for k, limit in limits.items()}

    def fault_readings(self) -> dict:
        """Each number with each fault planted in the reference that takes
        the program's place."""
        self._free()
        with harness.full_f32():
            want = self._reference()
            return {f: compare(self.names, self.sd, self._reference(fault=f), want)[0]
                    for f in ("half", "unchanged")}

    def witness_readings(self) -> dict:
        """Each number with the reference run at torch's default precision
        (cuDNN convolutions in TF32, as the program runs them) in the
        program's place: what rounding alone moves."""
        self._free()
        with harness.full_f32():
            want = self._reference()
        with harness.torch_defaults():
            got = self._reference()
        return compare(self.names, self.sd, got, want)[0]
