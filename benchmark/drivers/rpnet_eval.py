"""RP_Net episodic eval: the eval CLI's own pass function
(``rpnet_tpu_torch.cli.test_rpnet.evaluate``), pass after pass, on a runner
and a sampler built as the CLI's ``main`` builds them (the spec path: volumes
in the sampler's host LRU and the runner's device LRU, episodes shipped as
slice indices, episode j queued before j − 1 is settled).

Timed: each episode from the start of its ``sample_spec`` to the end of its
``finalize``, by wrappers on the instances this driver built, and the
window's settled episodes over its length. The window is whole passes (the
CLI drains the last episode of each), at least two, until ``--seconds``
have passed. Forward hooks on the runner's model keep, for a sample of
the window's episodes drawn from the seed (the longest query among them),
the network's inputs (the program's registration outputs), the encoder's
features, every CRE output and every refinement's logits; the check
compares the registration, the features, the CRE outputs, the head's
logits and the packed Dice/NCC with the plain reference.
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
from traffic.volumes import make_volume, write_dataset


class Cell:
    def __init__(self, run: harness.Run):
        self.run = run
        self.log = open(os.path.join(run.workdir, "program.log"), "w")
        self.records = []          # one dict an episode, in order
        self.by_spec, self.by_dispatch = {}, {}
        self.capture_keys, self.capturing = set(), None
        self.pass_no = -1          # the warm-up pass is pass 0

    # ------------------------------------------------------------ set-up
    def setup(self):
        from rpnet_tpu_torch.cli.test_rpnet import build_runner
        from rpnet_tpu_torch.config import Config
        from rpnet_tpu_torch.episode.sampler import EpisodeSampler

        run, tr = self.run, self.run.traffic
        s = harness.seeds(run.seed)
        gen = torch.Generator(device=run.device).manual_seed(s["torch"])
        rng = np.random.RandomState(s["numpy"])
        extents = [int(e) for e in rng.permutation(tr["liver_extents"])]
        vols = []
        for i, e in enumerate(extents):
            ct, masks = make_volume(tuple(tr["volume_shape"]), ["Liver"], {"Liver": e}, gen,
                                    run.device)
            vols.append((f"q{i:02d}", ct.cpu().numpy(), {k: m.cpu().numpy() for k, m in masks.items()}))
        self.volumes = {pid: (ct, m["Liver"]) for pid, ct, m in vols}
        paths = write_dataset(os.path.join(run.workdir, "data"), vols,
                              {"test": [v[0] for v in vols]}, ["Liver"])
        keys = harness.program_keys(run.config)
        keys.update(data_dir=paths["data_dir"], class_csv_dir=paths["class_csv_dir"],
                    eval_set_name=paths["test_csv"])
        config = Config(keys)
        self.config = config.replace(n_iter_refinement=config["n_test_iter_refinement"])
        # the CLI seeds both streams before it builds anything
        np.random.seed(s["numpy"])
        random.seed(s["random"])
        with contextlib.redirect_stdout(self.log):
            self.sampler = EpisodeSampler(config["data_dir"], config["eval_set_name"], self.config)
            self.runner = build_runner(self.config, run.device)
        self.sd = weights.draw(weights.template_of(self.runner.model), gen, run.device)
        self.runner.model.load_state_dict(self.sd)
        self._wrap()
        order = [self.sampler.data_info[ci][di]["pid"] for ci, di in self.sampler.indices]
        self.lengths = [extents[int(p[1:])] for p in order]
        # the episodes the check compares: the longest query of the window's
        # first pass, and two more of its first two passes, drawn from the seed
        crng = np.random.RandomState(s["check"])
        keys = [(1, int(np.argmax(self.lengths)))]
        for flat in crng.permutation(2 * len(order)):
            key = (1 + flat // len(order), int(flat % len(order)))
            if key not in keys and len(keys) < 3:
                keys.append(key)
        self.capture_keys = set(keys)
        self._pass()                              # warms every query length
        self.records.clear()
        run.attempted = run.failed = 0

    def _wrap(self):
        """Record each episode's times on the instances built above."""
        spans, sampler, runner = self.run.spans, self.sampler, self.runner
        sample_spec, dispatch_spec, finalize = (sampler.sample_spec, runner.dispatch_spec,
                                                runner.finalize)

        def timed_sample_spec(j, picks=None):
            t0 = time.perf_counter()
            with spans("sample"):
                spec = sample_spec(j, picks=picks)
            rec = {"key": (self.pass_no, j), "t0": t0, "spec": spec}
            self.records.append(rec)
            self.by_spec[id(spec)] = rec
            return spec

        def timed_dispatch_spec(spec, sampler_, arrays=False):
            rec = self.by_spec.pop(id(spec))
            self.capturing = rec if rec["key"] in self.capture_keys else None
            with spans("dispatch"):
                queued = dispatch_spec(spec, sampler_, arrays)
            self.capturing = None
            self.by_dispatch[id(queued)] = rec
            return queued

        def timed_finalize(queued):
            rec = self.by_dispatch.pop(id(queued))
            with spans("finalize"):
                res = finalize(queued)
            rec["t1"], rec["result"] = time.perf_counter(), res
            return res

        def keep(module, args, output):
            if self.capturing is not None:
                self.capturing["inputs"] = [a.detach() for a in args]
                self.capturing["refinement"] = output["refinement"].detach()

        def keep_features(module, args, output):
            if self.capturing is not None:
                self.capturing["features"] = output.detach()

        def keep_cre(module, args, output):
            if self.capturing is not None:
                self.capturing.setdefault("cre", []).append(output.detach())

        sampler.sample_spec, runner.dispatch_spec, runner.finalize = (
            timed_sample_spec, timed_dispatch_spec, timed_finalize)
        self.hooks = [runner.model.register_forward_hook(keep),
                      runner.model.encoder.register_forward_hook(keep_features),
                      runner.model.cre.register_forward_hook(keep_cre)]

    def _pass(self):
        from rpnet_tpu_torch.cli.test_rpnet import evaluate

        self.pass_no += 1
        with contextlib.redirect_stdout(self.log):
            failures = evaluate(self.runner, self.sampler, self.config)[3]
        self.run.attempted += len(self.sampler)
        self.run.failed += failures

    # ------------------------------------------------------------ window
    def window(self):
        run = self.run
        if run.trace:
            passes = int(run.traffic["trace_passes"])
            harness.traced_work(run, lambda: [self._pass() for _ in range(passes)])
            self._count_work(self.records[:passes * len(self.sampler)])
            return
        t0 = time.perf_counter()
        while True:
            self._pass()
            wall = time.perf_counter() - t0
            if wall >= run.seconds and self.pass_no >= 2:
                break
        done = [r for r in self.records if "t1" in r]
        run.metrics["episodes_per_s"] = (run.attempted - run.failed) / wall
        run.metrics["episode_p95_ms"] = harness.p95([(r["t1"] - r["t0"]) * 1e3 for r in done])

    def _count_work(self, records):
        """The FLOPs and the correlation calls the traced episodes need, by
        the reference at their query lengths (registration not counted)."""
        run, cfg = self.run, self.config
        T, r = int(cfg["n_iter_refinement"]), int(cfg["mask_refinement_correlation_radius"])
        meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in self.sd.items()}
        flops = {}
        for rec in records:
            n = rec["spec"].n_slices
            if n not in flops:
                H, W = cfg["crop_size"]
                x = torch.empty((n, H, W), device="meta")
                flops[n] = roofline.counted_flops(ref.rpnet, meta, x, x, x, x, x, T, r,
                                                  int(cfg["scale"]))
            shape = (n, cfg["crop_size"][0] // int(cfg["scale"]),
                     cfg["crop_size"][1] // int(cfg["scale"]), 256)
            run.corr_calls += [(shape, r, "bfloat16", False)] * (1 + T)
            run.work_flops = (run.work_flops or 0.0) + flops[n] + (1 + T) * roofline.corr_products(shape, r)
        run.peak_unit = roofline.UNIT_OF_DTYPE["bfloat16"]

    # ------------------------------------------------------------- check
    def check(self, control: bool = False):
        """Each compared number → (value, limit). With ``control`` the
        reference computed a step below the configuration's precisions takes
        the program's place: the network in fp8 (it states bf16), the
        registration in bf16 (it states f32)."""
        cfg, limits = self.config, self.run.traffic["limits"]
        picked = [r for r in self.records if "refinement" in r and "result" in r]
        for h in self.hooks:
            h.remove()
        self.runner = self.sampler = None
        self.log.close()
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        dev = self.run.device
        T, r, sc = (int(cfg["n_iter_refinement"]), int(cfg["mask_refinement_correlation_radius"]),
                    int(cfg["scale"]))
        reg_kw = dict(iters=int(cfg["reg_affine_iters"]), lr=float(cfg["reg_lr"]),
                      fit_scale=int(cfg["reg_fit_scale"]))
        worst = {"missing_episodes": float(len(self.capture_keys) - len(picked)),
                 "rows_mismatch": 0.0, "prior_mismatch": 0.0, "feature_rel_err": 0.0, "cre_rel_err": 0.0,
                 "head_rel_err": 0.0, "packed_gap": 0.0}
        rel = lambda a, b: float((a - b).norm() / b.norm())
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev, torch.float32)
        with harness.full_f32(), torch.no_grad():
            for rec in picked:
                spec = rec["spec"]
                s_img, s_lab = ref.preprocess(*self.volumes[spec.supp_key[0]], cfg)
                q_img, q_lab = ref.preprocess(*self.volumes[spec.qry_key[0]], cfg)
                rows = ref.support_rows(len(s_img), len(q_img), int(cfg["k"]))
                same = spec.n_slices == len(q_img) and np.array_equal(spec.supp_rows[0], rows)
                worst["rows_mismatch"] += 0.0 if same else 1.0
                supp, slab, qry, qlab = t(s_img[rows]), t(s_lab[rows]), t(q_img), t(q_lab)
                # registration: the reference's from the volumes
                reg = ref.register(supp, qry, slab, **reg_kw)
                supp_t, fore, back, qry_t, appr = (a.float() for a in rec["inputs"])
                if control:
                    reg_p = ref.register(supp, qry, slab, quant=precision.bf16, **reg_kw)
                    appr = reg_p["prior"]
                worst["prior_mismatch"] = max(worst["prior_mismatch"],
                                              float((reg["prior"] != appr).float().mean()))
                # the network, from the program's registration outputs (checked above)
                net_in = (supp_t[0, 0, ..., 0], fore[0, 0], back[0, 0], qry_t[..., 0], appr)
                imgs = torch.cat([net_in[0], net_in[3]])[:, None]
                f_ref = ref.unet(imgs, self.sd)
                f_prog = (ref.unet(imgs, self.sd, precision.fp8) if control
                          else rec["features"].float().permute(0, 3, 1, 2))
                worst["feature_rel_err"] = max(worst["feature_rel_err"], rel(f_prog, f_ref))
                # every CRE call (the support's, each refinement's), each iteration
                # from the program's previous hard mask, so that
                # a mask pixel flipped by rounding does not fork the chains
                if control:
                    out_p = ref.rpnet(self.sd, *net_in, T, r, sc, quant=precision.fp8)
                    l_prog, c_prog = out_p["refinement"], out_p["cre"]
                else:
                    l_prog = rec["refinement"].float().permute(0, 1, 4, 2, 3)
                    c_prog = [c.float().permute(0, 3, 1, 2) for c in rec["cre"]]
                chain = (torch.softmax(l_prog[:-1], 2)[:, :, 1] > 0.5).float()
                out_r = ref.rpnet(self.sd, *net_in, T, r, sc, masks=chain)
                worst["cre_rel_err"] = max([worst["cre_rel_err"]]
                                           + [rel(a, b) for a, b in zip(c_prog, out_r["cre"])])
                # the head after CRE (prototypes, cosine, upsampling), each
                # iteration from the program's own CRE outputs (checked above)
                fg, bg = (ref.masked_pool(c_prog[0], m) for m in net_in[1:3])
                heads = [ref.head(c, fg, bg, l_prog.shape[-2:])[1] for c in c_prog[1:]]
                worst["head_rel_err"] = max([worst["head_rel_err"]]
                                            + [rel(a, b) for a, b in zip(l_prog, heads)])
                # the packed vector: the program's, against the reference's
                # metrics of its registration and of the program's own masks
                masks = (torch.softmax(l_prog, 2)[:, :, 1] > 0.5).float()
                met = ref.episode_metrics(reg, masks, supp, qry, qlab)
                if control:
                    prog = ref.episode_metrics(reg_p, masks, supp, qry, qlab)
                else:
                    res = rec["result"]
                    prog = {"dsc_affine": res["dsc_affine"], "dsc_fewshot": res["dsc_fewshot"],
                            "ncc_warped": res["ncc_warped"], "ncc_raw": res["ncc_raw"],
                            **{f"ref_{i}": v for i, v in res["dsc_refinement"].items()}}
                gap = max(abs(float(prog[k]) - met[k]) if prog[k] is not None else float("inf")
                          for k in met)
                worst["packed_gap"] = max(worst["packed_gap"], gap)
        return {k: (v, limits[k]) for k, v in worst.items()}
