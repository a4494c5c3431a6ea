"""LGCANet_V3 whole-volume eval: ``train/lgca.evaluate_lgca_volume`` over
the eval split's volumes, each sampled by the ``LGCAVolumeSampler`` in eval
mode (held in its LRU after set-up), as the eval CLI's ``eval_lgca`` runs
it on one device: 18 chunks of 16 slices a 288-slice volume, each one eval
forward of the whole model, one fetch of the predictions, the Dice on the
host.

The window is whole passes over the volumes until ``--seconds`` have passed;
``volumes_per_s`` is the volumes evaluated over its length. Forward hooks
on the model keep, for one volume of the window's first pass drawn from
the seed, the context net's outputs, every chunk's logits and the first
chunks' last decoder features; the check compares the sampled volume, the
context net, the decoder and the logits (each over the error of a witness,
the reference at the program's precision) and the answer (each ROI's Dice
against the Dice of the program's own predictions) with the plain
reference, and records the predictions' gaps.
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
from traffic.volumes import make_volume, write_dataset

CHUNK = 16   # evaluate_lgca_volume's default, which the CLI uses
DECODER_CHUNKS = 4   # chunks whose last decoder features the check keeps
WITNESS_FLOOR = 1e-6   # the least relative error a witness is taken to read


class Cell:
    def __init__(self, run: harness.Run):
        self.run = run
        self.log = open(os.path.join(run.workdir, "program.log"), "w")
        self.pass_no, self.capture, self.kept = -1, None, None

    def setup(self):
        from rpnet_tpu_torch.config import Config
        from rpnet_tpu_torch.episode.lgca_data import LGCAVolumeSampler
        from rpnet_tpu_torch.models.factory import build_lgcanet

        run, tr = self.run, self.run.traffic
        s = harness.seeds(run.seed)
        gen = torch.Generator(device=run.device).manual_seed(s["torch"])
        rois = list(run.config["roi_names"])
        vols = []
        for i in range(int(tr["volumes"])):
            ct, masks = make_volume(tuple(tr["volume_shape"]), rois, None, gen, run.device)
            vols.append((f"e{i:02d}", ct.cpu().numpy(), {k: m.cpu().numpy() for k, m in masks.items()}))
        self.volumes = {pid: (ct, m) for pid, ct, m in vols}
        paths = write_dataset(os.path.join(run.workdir, "data"), vols,
                              {"test": [v[0] for v in vols]}, rois)
        keys = harness.program_keys(run.config)
        keys.update(data_dir=paths["data_dir"], eval_set_name=paths["test_csv"])
        self.config = Config(keys)
        np.random.seed(s["numpy"])
        random.seed(s["random"])
        with contextlib.redirect_stdout(self.log):
            self.sampler = LGCAVolumeSampler(paths["data_dir"], paths["test_csv"], self.config,
                                             mode="eval")
            self.model = build_lgcanet(self.config, seed=0, device=run.device)
        self.sd = weights.draw(weights.template_of(self.model), gen, run.device)
        self.model.load_state_dict(self.sd)
        self.pick = (1, int(np.random.RandomState(s["check"]).randint(len(self.sampler))))

        def keep(module, args, output):
            if self.capture is not None:
                self.capture["logits"].append(output["seg_2d"].detach())

        def keep_context(module, args, output):
            if self.capture is not None and "context" not in self.capture:
                self.capture["context"] = {k: v.detach().clone() for k, v in output.items()}

        def keep_decoder(module, args, output):
            if self.capture is not None and len(self.capture["decoder"]) < DECODER_CHUNKS:
                self.capture["decoder"].append(output.detach().clone())

        self.hooks = [self.model.register_forward_hook(keep),
                      self.model.context_net.register_forward_hook(keep_context),
                      self.model.unet.Up_conv2.register_forward_hook(keep_decoder)]
        self._pass()                              # every volume into the LRU, warm
        run.attempted = run.failed = 0

    def _pass(self):
        from rpnet_tpu_torch.train.lgca import evaluate_lgca_volume

        self.pass_no += 1
        spans = self.run.spans
        for j in range(len(self.sampler)):
            self.run.attempted += 1
            with spans("sample"):
                sample = self.sampler.sample(j)
            if (self.pass_no, j) == self.pick:
                self.capture = {"sample": sample, "logits": [], "decoder": [], "dices": None}
            try:
                with spans("evaluate"):
                    dices = evaluate_lgca_volume(self.model, sample, self.run.device, chunk=CHUNK)
            except Exception as e:                # counted, as the CLI counts it
                print(f"{j} VOLUME FAILED: {e!r}", file=self.log)
                self.run.failed += 1
                dices = None
            if self.capture is not None:
                self.capture["dices"] = dices
                self.kept, self.capture = self.capture, None

    def window(self):
        run = self.run
        if run.trace:
            passes = int(run.traffic["trace_passes"])
            harness.traced_work(run, lambda: [self._pass() for _ in range(passes)])
            run.work_flops = passes * len(self.sampler) * self._volume_flops()
            run.peak_unit = roofline.UNIT_OF_DTYPE["float32"]
            return
        t0 = time.perf_counter()
        done = 0
        while done == 0 or time.perf_counter() - t0 < run.seconds:
            self._pass()                          # whole passes, as the CLI's loop
            done = run.attempted
        run.metrics["volumes_per_s"] = (run.attempted - run.failed) / (time.perf_counter() - t0)

    def _volume_flops(self) -> float:
        """FLOPs one volume needs: the context net once, the 2D U-Net over
        every slice (counted on the reference)."""
        sample = self.sampler.sample(0)
        meta = lambda a: torch.empty(a.shape, device="meta")
        p = {n: meta(v) for n, v in self.sd.items() if v.is_floating_point()}
        vol = meta(sample["volume"]).permute(0, 4, 1, 2, 3)
        chunk = meta(sample["slices"][:CHUNK]).permute(0, 3, 1, 2)
        context = roofline.counted_flops(ref.context_net, vol, p)
        feats = ref.context_net(vol, p)
        per_chunk = roofline.counted_flops(ref.lgca, p, vol, chunk, feats=feats)
        return context + -(-sample["slices"].shape[0] // CHUNK) * per_chunk

    def check(self, control: bool = False):
        """Each compared number → (value, limit). With ``control`` the
        reference computed in bf16 (the configuration states f32) takes the
        program's place."""
        limits = self.run.traffic["limits"]
        for h in self.hooks:
            h.remove()
        self.model = self.sampler = None
        self.log.close()
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        worst = {"missing_volumes": 1.0, "input_gap": 0.0, "context_rel_err": 0.0,
                 "decoder_ratio": float("inf"), "logits_ratio": float("inf"), "answer_gap": 0.0}
        if self.kept is None or self.kept.get("dices") is None:
            return {k: (worst[k], limit) for k, limit in limits.items()}
        worst["missing_volumes"] = 0.0
        cfg, dev, s = self.config, self.run.device, self.kept["sample"]
        vol, masks = ref.prepare_volume(*self.volumes[s["pid"]], cfg)
        sz, sy, sx = cfg["context_net_downsample_scale"]
        want_vol = vol[::sz, ::sy, ::sx][None, ..., None]
        for got, want in ((s["volume"], want_vol), (s["slices"], vol[..., None]), (s["mask"], masks)):
            worst["input_gap"] = max(worst["input_gap"], float("inf") if got.shape != want.shape
                                     else float(np.abs(got - want).max()))
        rel = lambda a, b: float((a - b).norm() / b.norm())
        D, gt = vol.shape[0], torch.from_numpy(masks).to(dev) > 0.5
        dice = lambda p, k: 2 * int((p[..., k] & gt[..., k]).sum()) / (
            int(p[..., k].sum()) + int(gt[..., k].sum()))
        with harness.full_f32(), torch.no_grad():
            v = torch.from_numpy(want_vol).to(dev).permute(0, 4, 1, 2, 3)
            sl = torch.from_numpy(vol[:, None]).to(dev)
            feats = ref.context_net(v, self.sd)
            with harness.torch_defaults():
                feats_w = ref.context_net(v, self.sd)
            feats_p = (ref.context_net(v, self.sd, precision.bf16) if control else
                       {k: t.permute(0, 4, 1, 2, 3) for k, t in self.kept["context"].items()})
            worst["context_rel_err"] = max(rel(feats_p[k], feats[k]) for k in feats)
            preds_p, preds_r, dec_errs, logit_errs = [], [], [], []
            for c, z0 in enumerate(range(0, D, CHUNK)):
                chunk = sl[z0:z0 + CHUNK]
                if chunk.shape[0] < CHUNK:
                    chunk = torch.cat([chunk, chunk.new_zeros((CHUNK - chunk.shape[0],) + chunk.shape[1:])])
                out_r = ref.lgca(self.sd, v, chunk, feats=feats)
                with harness.torch_defaults():
                    out_w = ref.lgca(self.sd, v, chunk, feats=feats_w)
                if control:
                    out_p = ref.lgca(self.sd, v, chunk, quant=precision.bf16, feats=feats_p)
                    lp, dec_p = out_p["seg_2d"], out_p["decoder"]
                else:
                    lp = self.kept["logits"][c].float().permute(0, 3, 1, 2)
                    dec_p = (self.kept["decoder"][c].float().permute(0, 3, 1, 2)
                             if c < len(self.kept["decoder"]) else None)
                if dec_p is not None and c < DECODER_CHUNKS:
                    dec_errs.append((rel(dec_p, out_r["decoder"]),
                                     rel(out_w["decoder"], out_r["decoder"])))
                logit_errs.append((rel(lp, out_r["seg_2d"]), rel(out_w["seg_2d"], out_r["seg_2d"])))
                n = min(CHUNK, D - z0)
                preds_p.append((torch.sigmoid(lp[:n]) > 0.5).permute(0, 2, 3, 1))
                preds_r.append((torch.sigmoid(out_r["seg_2d"][:n]) > 0.5).permute(0, 2, 3, 1))
            pp, pr = torch.cat(preds_p), torch.cat(preds_r)
            # the answer: each ROI's Dice as the program gave it, against the
            # Dice of its own predictions (exact), and against the reference's
            dice_gap = 0.0
            for k in range(gt.shape[-1]):
                if not bool(gt[..., k].any()):
                    continue
                d_prog = dice(pp, k) if control else self.kept["dices"][f"class_{k}"]
                worst["answer_gap"] = max(worst["answer_gap"], abs(d_prog - dice(pp, k)))
                dice_gap = max(dice_gap, abs(d_prog - dice(pr, k)))
        # the 2D path's error over the witness's, the reference at the
        # program's precision: the eval-mode U-Net's conditioning at the
        # seed's weights moves both alike. The witness reads no less than
        # f32's rounding, where no TF32 runs (the CPU).
        ratio = lambda errs: (max(e for e, _ in errs)
                              / max(max(w for _, w in errs), WITNESS_FLOOR))
        worst["decoder_ratio"], worst["logits_ratio"] = ratio(dec_errs), ratio(logit_errs)
        # for the record
        self.details = {"decoder_rel_err": [max(e) for e in zip(*dec_errs)],
                        "logits_rel_err": [max(e) for e in zip(*logit_errs)],
                        "pred_mismatch": float((pp != pr).float().mean()), "dice_gap": dice_gap}
        return {k: (worst[k], limit) for k, limit in limits.items()}
