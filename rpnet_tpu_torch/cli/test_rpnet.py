"""Episodic evaluation CLI on PyTorch: the port's main entry point.

    python -m rpnet_tpu_torch.cli.test_rpnet --yaml yamls/example.yml

The counterpart of ``rpnet_tpu/cli/test_rpnet.py`` (the reference eval
script's protocol, test_rpnet.py:39-258): seeds numpy/random for the
support draws, overrides ``n_iter_refinement`` with
``n_test_iter_refinement``, runs
``n_runs`` eval passes with the same per-episode log lines and mean±std
block, tees stdout to ``out_dir/log_eval`` and writes ``results_eval.json``
with the same keys.

It runs on the GPU (``--platform gpu``, the default) and raises when there
is none; ``--platform cpu`` runs on the CPU with the kernels' plain versions.
``ckpt: null`` gives a seeded init; a ``.pth`` path loads a torch checkpoint.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time
import traceback
from collections import defaultdict
from typing import Dict

import numpy as np
import torch

from rpnet_tpu_torch.config import Config, load_yaml
from rpnet_tpu_torch.episode.pipeline import EpisodeRunner
from rpnet_tpu_torch.episode.sampler import EpisodeSampler
from rpnet_tpu_torch.models.factory import build_rpnet
from rpnet_tpu_torch.utils.logger import Logger

parser = argparse.ArgumentParser(description="RP-Net episodic eval (PyTorch)")
parser.add_argument("--yaml", default=None, type=str, metavar="N",
                    help="experiment configuration YAML")
parser.add_argument("--platform", default="gpu", choices=("gpu", "cpu"),
                    help="gpu (default; raises without one) or cpu")
parser.add_argument("--n-runs", default=None, type=int,
                    help="override n_runs from the YAML")


def resolve_device(platform: str) -> torch.device:
    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("--platform gpu: no CUDA device is available "
                           "(pass --platform cpu to run on the CPU)")
    return torch.device("cuda")


def build_runner(config: Config, device, seed: int = 0) -> EpisodeRunner:
    """The runner of the model (seeded init, or the configured ``.pth``)."""
    model = build_rpnet(config, num_iter=config["n_iter_refinement"], seed=seed)
    ckpt = config.get("ckpt")
    if ckpt:
        if not ckpt.endswith((".pth", ".pt", ".tar")):
            raise NotImplementedError(
                f"ckpt {ckpt}: only torch .pth checkpoints load into "
                "rpnet_tpu_torch (orbax checkpoints need the JAX package)")
        from rpnet_tpu_torch.train.convert import load_into, load_torch_checkpoint
        print(f"[Loading model from {ckpt}]")
        load_into(model, load_torch_checkpoint(ckpt)["state_dict"])
    runner = EpisodeRunner(model, config, device)
    dt = config.get("compute_dtype") or "bfloat16 (auto)"
    print(f"[network compute dtype {dt}; registration/metrics f32 — "
          f"set compute_dtype to override]")
    return runner


class _StageTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def add(self, name: str, seconds: float):
        self.totals[name] += seconds
        self.counts[name] += 1

    def report(self) -> str:
        parts = [f"{k}={self.totals[k]:.3f}s/{self.counts[k]}x"
                 for k in sorted(self.totals, key=self.totals.get, reverse=True)]
        return "stage_timing " + " ".join(parts)


def evaluate(runner: EpisodeRunner, sampler: EpisodeSampler, config: Config):
    """One eval pass (reference eval(), test_rpnet.py:151-258).

    Each episode runs under its own try/except, as in the JAX CLI: a failure
    is logged and counted, and the pass goes on. Callers check the count.
    """
    eval_classes = config["eval_classes"]
    n_eps = len(sampler)
    timer = _StageTimer()
    # all supports of the pass are drawn first, from the shared seed
    all_picks = [sampler.draw_supports(j) for j in range(n_eps)]

    dsc_affine_list = defaultdict(list)
    dsc_fewshot_list = defaultdict(list)
    dsc_refinement_list = defaultdict(lambda: defaultdict(list))
    failures = 0
    for j in range(n_eps):
        try:
            t0 = time.perf_counter()
            ep = sampler.sample(j, picks=all_picks[j])
            t1 = time.perf_counter()
            res = runner.run(ep)
            timer.add("data", t1 - t0)
            timer.add("episode", time.perf_counter() - t1)
        except Exception:
            failures += 1
            print(f"{j} EPISODE FAILED — skipping:\n{traceback.format_exc()}")
            continue
        cls = eval_classes[ep.class_id]
        supp_pid = sampler.data_info[ep.supp_pids[0][0]][ep.supp_pids[0][1]]["pid"]
        print(f"{j} {ep.pid} {supp_pid} affine ({res['ncc_warped']:.4f}, "
              f"{res['ncc_raw']:.4f}) {res['dsc_affine']}, "
              f"fewshot {res['dsc_fewshot']}", end=" ")
        dsc_affine_list[cls].append(res["dsc_affine"])
        dsc_fewshot_list[cls].append(res["dsc_fewshot"])
        for it, v in res["dsc_refinement"].items():
            dsc_refinement_list[cls][it].append(v)
            print(f"ref {it} {v}, ", end=" ")
        print()

    for cls in eval_classes:
        aff = [d for d in dsc_affine_list[cls] if d is not None]
        few = [d for d in dsc_fewshot_list[cls] if d is not None]
        print(f"{cls}, affine {np.average(aff) if aff else float('nan')}, "
              f"fewshot {np.average(few) if few else float('nan')}", end=" ")
        for it, l in dsc_refinement_list[cls].items():
            vals = [v for v in l if v is not None]
            print(f"ref {it} {np.average(vals) if vals else float('nan')}, ", end=" ")
        print()
    if failures:
        print(f"[{failures} episode(s) failed this pass]")
    print(timer.report())
    return dsc_affine_list, dsc_fewshot_list, dsc_refinement_list, failures


def main(argv=None):
    args = parser.parse_args(argv)
    if not args.yaml:
        print("No configuration file")
        return None
    device = resolve_device(args.platform)

    config = Config(load_yaml(args.yaml))
    # eval uses the test-time refinement depth (test_rpnet.py:51)
    config = config.replace(n_iter_refinement=config["n_test_iter_refinement"])
    if config.get("net", "RP_Net") != "RP_Net" or config.get("eval_3d"):
        raise NotImplementedError("rpnet_tpu_torch ports the RP_Net episodic "
                                  "eval only (no LGCANet_V3, no eval_3d yet)")

    seed = int(config.get("seed", 0))
    np.random.seed(seed)
    random.seed(seed)

    out_dir = config.get("out_dir") or "./results/{}/".format(
        os.path.splitext(os.path.basename(args.yaml))[0])
    os.makedirs(os.path.join(out_dir, "model"), exist_ok=True)
    logger = Logger(os.path.join(out_dir, "log_eval"))
    sys.stdout = logger
    try:
        sampler = EpisodeSampler(config["data_dir"], config["eval_set_name"],
                                 config)
        print(f"[length of eval loader {len(sampler)}]")
        runner = build_runner(config, device, seed)
        n_runs = args.n_runs or config.get("n_runs", 1)
        return run_eval_protocol(runner, sampler, config, out_dir, n_runs)
    finally:
        sys.stdout = logger.terminal
        logger.close()


def run_eval_protocol(runner, sampler, config: Config, out_dir: str, n_runs: int):
    """The reference's n_runs protocol (test_rpnet.py:112-145): repeat the
    per-class episodic eval, aggregate mean±std over runs, write
    results_eval.json."""
    eval_classes = config["eval_classes"]
    dsc_affine = defaultdict(list)
    dsc_fewshot = defaultdict(list)
    dsc_refinement = defaultdict(lambda: defaultdict(list))
    t0 = time.time()
    total_episodes = 0
    total_failures = 0
    for i in range(n_runs):
        print(f"{i + 1} / {n_runs}")
        t_pass = time.time()
        a, f, r, failures = evaluate(runner, sampler, config)
        print(f"pass_wall {time.time() - t_pass:.3f}s / {len(sampler)} episodes")
        total_episodes += len(sampler)
        total_failures += failures
        for k in eval_classes:
            dsc_affine[k].append(list(a[k]))
            dsc_fewshot[k].append(list(f[k]))
            for it, l in r[k].items():
                dsc_refinement[k][it].append(l)

    wall = time.time() - t0
    results: Dict[str, Dict] = {"classes": {}, "wall_time_sec": wall,
                                "episodes": total_episodes,
                                "failed_episodes": total_failures,
                                # completed episodes only
                                "episodes_per_sec":
                                    (total_episodes - total_failures)
                                    / max(wall, 1e-9)}

    def _nanmean_std(rows):
        """Mean over episodes per run, then mean±std over runs
        (the `.mean(1).mean()` / `.mean(1).std()` protocol, test_rpnet.py:138-143)."""
        per_run = []
        for row in rows:
            vals = [v for v in row if v is not None]
            per_run.append(np.mean(vals) if vals else np.nan)
        return float(np.nanmean(per_run)), float(np.nanstd(per_run))

    print("=======Average performance=========")
    ref_dsc = []
    for k in eval_classes:
        am, astd = _nanmean_std(dsc_affine[k])
        fm, fstd = _nanmean_std(dsc_fewshot[k])
        print(f"{k}, affine {am} + {astd}, fewshot {fm} + {fstd} ")
        results["classes"][k] = {"affine": [am, astd], "fewshot": [fm, fstd],
                                 "refinement": {}}
        for it, rows in dsc_refinement[k].items():
            rm, rstd = _nanmean_std(rows)
            ref_dsc.append(rm)
            results["classes"][k]["refinement"][int(it)] = [rm, rstd]
            print(f"ref {it} {rm} + {rstd}, ", end=" ")
        print()
    print(ref_dsc)

    with open(os.path.join(out_dir, "results_eval.json"), "w") as fjson:
        json.dump(results, fjson, indent=2)
    return results


if __name__ == "__main__":
    main()
