"""Episodic evaluation CLI on PyTorch: the port's main entry point.

    python -m rpnet_tpu_torch.cli.test_rpnet --yaml yamls/example.yml

The counterpart of ``rpnet_tpu/cli/test_rpnet.py`` (the reference eval
script's protocol, test_rpnet.py:39-258): seeds numpy/random for the
support draws, overrides ``n_iter_refinement`` with
``n_test_iter_refinement``, runs
``n_runs`` eval passes with the same per-episode log lines and mean±std
block, tees stdout to ``out_dir/log_eval`` and writes ``results_eval.json``
with the same keys.

The data path is the JAX CLI's: with ``device_volume_cache`` > 0 (the
default) an episode ships as slice indices into volumes held on the device
(``EpisodeSpec``); with the cache off, ``num_workers`` threads assemble the
episodes ahead on the host. Episode j is queued before episode j - 1 is
settled. The ``stage_timing`` line reports the host seconds of the ``data``,
``dispatch`` and ``episode_compute`` (waiting for an episode's result)
stages. With ``eval_3d`` each pass segments every slice of each query volume
instead (``episode/volume3d.py``, sliding windows).

Several processes (``multihost: true`` with ``coordinator_address``,
``num_processes`` and ``process_id``, or torchrun's variables; on one card
or on several) form a gloo group (``parallel/mesh.py``): each evaluates a
strided shard of the episodes (or of the eval_3d volumes), prints their
lines, and every process prints the same aggregate of the merged records.
``mesh_shape`` is resolved per process as the JAX CLI resolves it (a shape
needing more devices than the process has raises the JAX message); where
its data axis is above 1, each episode's query slices are split over the
mesh's data devices (``EpisodeRunner(mesh=...)``, one host thread
enqueueing every device's shard). A single process on several cards takes
them all unless ``mesh_shape`` says otherwise, as the JAX CLI takes every
chip. ``debug_nans``
turns on ``utils/profiling.enable_nan_debugging`` for the model: the first
NaN raises ``FloatingPointError`` (or anomaly detection's error in a
backward) inside the episode, which is then logged, counted as failed and
skipped, as the JAX CLI counts a ``jax_debug_nans`` error.

``net: LGCANet_V3`` runs :func:`eval_lgca` instead, the JAX CLI's
whole-volume eval (``rpnet_tpu/cli/test_rpnet.py:326-382``): per-ROI Dice of
every eval volume, one line a volume, the average block and
``results_eval.json``, with its mesh resolved the same way (each chunk of
slices split over the data devices).

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
from rpnet_tpu_torch.episode.prefetch import EpisodeFailure, PrefetchingSampler
from rpnet_tpu_torch.episode.sampler import EpisodeSampler, EpisodeSpec
from rpnet_tpu_torch.episode.lgca_data import LGCAVolumeSampler
from rpnet_tpu_torch.episode.volume3d import Volume3DRunner, Volume3DSampler
from rpnet_tpu_torch.models.factory import build_lgcanet, build_rpnet
from rpnet_tpu_torch.parallel.mesh import (allgather_merge_records, local_devices,
                                           maybe_initialize_distributed,
                                           resolve_cli_mesh, shard_indices)
from rpnet_tpu_torch.train.lgca import evaluate_lgca_volume
from rpnet_tpu_torch.utils.logger import Logger
from rpnet_tpu_torch.utils.profiling import StageTimer, enable_nan_debugging

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


def check_net(config: Config) -> None:
    """The ``net`` values both CLIs run."""
    net = config["net"]
    if net not in ("RP_Net", "LGCANet_V3"):
        raise NotImplementedError(f"net: {net!r} is not ported to rpnet_tpu_torch "
                                  "(ported: RP_Net, LGCANet_V3)")


def start_process(config: Config, device: torch.device) -> torch.device:
    """What both CLIs do before anything touches the device: join the
    process group where the YAML or torchrun asks for it
    (``rpnet_tpu/cli/test_rpnet.py:399-400``), then this process's device
    (on the card ``cuda:(rank % cards)``, made current)."""
    maybe_initialize_distributed(config)
    if device.type == "cuda":
        device = local_devices("cuda")[0]
        torch.cuda.set_device(device)
    return device


def load_checkpoint_into(model, config: Config) -> None:
    """The configured ``ckpt`` (a torch ``.pth``) into ``model``, if any."""
    ckpt = config.get("ckpt")
    if not ckpt:
        return
    if not ckpt.endswith((".pth", ".pt", ".tar")):
        raise NotImplementedError(
            f"ckpt {ckpt}: only torch .pth checkpoints load into "
            "rpnet_tpu_torch (orbax checkpoints need the JAX package)")
    from rpnet_tpu_torch.train.convert import load_into, load_torch_checkpoint
    print(f"[Loading model from {ckpt}]")
    load_into(model, load_torch_checkpoint(ckpt)["state_dict"])


def sharding_mesh(mesh):
    """The resolved mesh where its data axis splits work, else None (the
    one-device path; a ``model`` axis alone adds nothing to eval)."""
    return mesh if mesh is not None and mesh.shape["data"] > 1 else None


def build_runner(config: Config, device, seed: int = 0) -> EpisodeRunner:
    """The runner of the model (seeded init, or the configured ``.pth``)."""
    model = build_rpnet(config, num_iter=config["n_iter_refinement"], seed=seed)
    load_checkpoint_into(model, config)
    # mesh_shape (or several local devices) resolved as the JAX CLI does
    # (rpnet_tpu/cli/test_rpnet.py:76-83); the query slices shard over its
    # data axis, episodes across processes
    mesh = sharding_mesh(resolve_cli_mesh(config.get("mesh_shape"), device))
    runner = EpisodeRunner(model, config, device, mesh=mesh)
    dt = config.get("compute_dtype") or "bfloat16 (auto)"
    print(f"[network compute dtype {dt}; registration/metrics f32 — "
          f"set compute_dtype to override]")
    return runner


def _per_class(eval_classes, rec_cls, rec_aff, rec_few, rec_ref=None):
    """Per-class Dice lists rebuilt from the merged records (NaN = None, the
    reference's empty-ground-truth convention), in episode order."""
    value = lambda v: None if np.isnan(v) else float(v)
    dsc_affine_list = defaultdict(list)
    dsc_fewshot_list = defaultdict(list)
    dsc_refinement_list = defaultdict(lambda: defaultdict(list))
    for j in range(len(rec_cls)):
        if rec_cls[j] < 0:
            continue
        cls = eval_classes[int(rec_cls[j])]
        dsc_affine_list[cls].append(value(rec_aff[j]))
        dsc_fewshot_list[cls].append(value(rec_few[j]))
        if rec_ref is not None:
            for it, v in enumerate(rec_ref[j]):
                dsc_refinement_list[cls][it].append(value(v))
    return dsc_affine_list, dsc_fewshot_list, dsc_refinement_list


def evaluate(runner: EpisodeRunner, sampler: EpisodeSampler, config: Config):
    """One eval pass (reference eval(), test_rpnet.py:151-258), as the JAX
    CLI's ``evaluate`` runs it.

    Every episode's supports are drawn first, from the shared seed, in every
    process; each process then evaluates its strided shard of the episodes
    (all of them when it runs alone) and prints their lines, and the
    records merge across processes, so every process aggregates and prints
    the same numbers. An episode takes the index-only path
    (:meth:`EpisodeSampler.sample_spec`, :meth:`EpisodeRunner.dispatch_spec`)
    where the runner has a device volume cache and the sampler gives a spec;
    otherwise it is assembled on the host, by ``num_workers`` prefetch
    threads where there are any. The episodes are pipelined: episode j is
    queued before the previous one is settled, and the lines print in index
    order. Each episode's data, dispatch and settle run under their own
    try/except, as in the JAX CLI: a failure is logged and counted, and the
    pass goes on (under ``debug_nans`` a NaN is such a failure). Callers check the
    count.
    """
    eval_classes = config["eval_classes"]
    n_eps = len(sampler)
    T = int(config["n_iter_refinement"])
    timer = StageTimer()
    my_idxs = shard_indices(n_eps)
    all_picks = [sampler.draw_supports(j) for j in range(n_eps)]
    use_spec = runner.supports_spec

    if config.get("num_workers", 0) and not use_spec:
        iterator = iter(PrefetchingSampler(
            sampler, lookahead=2, workers=int(config["num_workers"]),
            indices=my_idxs, picks=all_picks))

        def fetch(j):
            ep = next(iterator)
            if isinstance(ep, EpisodeFailure):
                raise ep.exc
            return ep
    else:
        def fetch(j):
            return sampler.sample(j, picks=all_picks[j])

    # per-episode records (-1 / NaN = not this process's, failed, or empty
    # ground truth): the multi-process merge is an elementwise combine
    rec_cls = np.full(n_eps, -1, np.int32)
    rec_aff = np.full(n_eps, np.nan, np.float64)
    rec_few = np.full(n_eps, np.nan, np.float64)
    rec_ref = np.full((n_eps, T), np.nan, np.float64)

    def settle(j, ep, queued) -> int:
        """Wait for a queued episode, record and print it; 1 if it failed."""
        try:
            with timer.stage("episode_compute"):
                res = runner.finalize(queued)
        except Exception:
            print(f"{j} EPISODE FAILED — skipping:\n{traceback.format_exc()}")
            return 1
        supp_pid = sampler.data_info[ep.supp_pids[0][0]][ep.supp_pids[0][1]]["pid"]
        print(f"{j} {ep.pid} {supp_pid} affine ({res['ncc_warped']:.4f}, "
              f"{res['ncc_raw']:.4f}) {res['dsc_affine']}, "
              f"fewshot {res['dsc_fewshot']}", end=" ")
        rec_cls[j] = ep.class_id
        if res["dsc_affine"] is not None:
            rec_aff[j] = res["dsc_affine"]
        if res["dsc_fewshot"] is not None:
            rec_few[j] = res["dsc_fewshot"]
        for it, v in res["dsc_refinement"].items():
            if v is not None:
                rec_ref[j, int(it)] = v
            print(f"ref {it} {v}, ", end=" ")
        print()
        return 0

    failures = 0
    pending = None
    for j in my_idxs:
        try:
            with timer.stage("data"):
                ep = sampler.sample_spec(j, picks=all_picks[j]) if use_spec else None
                if ep is None:
                    ep = fetch(j)
            with timer.stage("dispatch"):
                queued = (runner.dispatch_spec(ep, sampler)
                          if isinstance(ep, EpisodeSpec) else runner.dispatch(ep))
        except Exception:
            if pending is not None:
                failures += settle(*pending)
                pending = None
            failures += 1
            print(f"{j} EPISODE FAILED — skipping:\n{traceback.format_exc()}")
            continue
        if pending is not None:
            failures += settle(*pending)
        pending = (j, ep, queued)
    if pending is not None:
        failures += settle(*pending)

    records, failures = allgather_merge_records((rec_cls, rec_aff, rec_few, rec_ref),
                                                failures)
    dsc_affine_list, dsc_fewshot_list, dsc_refinement_list = _per_class(eval_classes,
                                                                        *records)
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


def evaluate_3d(runner: EpisodeRunner, sampler: EpisodeSampler, config: Config):
    """One whole-volume eval pass (``eval_3d``; the JAX CLI's ``evaluate_3d``,
    rpnet_tpu/cli/test_rpnet.py:234-320): every query slice segmented in
    sliding z-windows, the overlaps averaged, per-volume Dice aggregated per
    class. Each process evaluates its strided shard of the volumes and the
    records merge, as in :func:`evaluate`; every volume's support is drawn
    first, in every process, so a shard pairs each volume with the support
    of a single-process run (the JAX CLI draws only its own volumes'
    supports, so its shards pair others). A volume's failure is logged and
    counted, and the pass goes on."""
    eval_classes = config["eval_classes"]
    vrunner = Volume3DRunner(runner, window=runner.bucket,
                             overlap=int(config.get("overlap_3d", 8)))
    vsampler = Volume3DSampler(sampler)
    n_vols = len(vsampler)
    rec_cls = np.full(n_vols, -1, np.int32)
    rec_aff = np.full(n_vols, np.nan, np.float64)
    rec_few = np.full(n_vols, np.nan, np.float64)
    failures = 0
    all_picks = [vsampler.draw_support(j) for j in range(n_vols)]
    for j in shard_indices(n_vols):
        try:
            supp_img, supp_lab, qry_img, qry_lab, meta = vsampler.sample(j, all_picks[j])
            res = vrunner.run_volume(supp_img, supp_lab, qry_img, qry_lab,
                                     sampler=sampler, supp_key=meta["supp_key"],
                                     qry_key=meta["qry_key"])
        except Exception:
            failures += 1
            print(f"{j} VOLUME FAILED — skipping:\n{traceback.format_exc()}")
            continue
        print(f"{j} {meta['pid']} {meta['supp_pid']} affine {res.dsc_affine}, "
              f"fewshot {res.dsc_fewshot} ({res.n_windows} windows)")
        rec_cls[j] = meta["class_id"]
        if res.dsc_affine is not None:
            rec_aff[j] = res.dsc_affine
        if res.dsc_fewshot is not None:
            rec_few[j] = res.dsc_fewshot

    records, failures = allgather_merge_records((rec_cls, rec_aff, rec_few), failures)
    dsc_affine_list, dsc_fewshot_list, _ = _per_class(eval_classes, *records)
    for cls in eval_classes:
        aff = [d for d in dsc_affine_list[cls] if d is not None]
        few = [d for d in dsc_fewshot_list[cls] if d is not None]
        dsc_affine_list[cls], dsc_fewshot_list[cls] = aff, few
        print(f"{cls}, affine {np.average(aff) if aff else float('nan')}, "
              f"fewshot {np.average(few) if few else float('nan')}")
    if failures:
        print(f"[{failures} volume(s) failed this pass]")
    return dsc_affine_list, dsc_fewshot_list, defaultdict(lambda: defaultdict(list)), failures


def main(argv=None):
    args = parser.parse_args(argv)
    if not args.yaml:
        print("No configuration file")
        return None
    device = resolve_device(args.platform)
    config = Config(load_yaml(args.yaml))
    # eval uses the test-time refinement depth (test_rpnet.py:51)
    config = config.replace(n_iter_refinement=config["n_test_iter_refinement"])
    check_net(config)
    device = start_process(config, device)

    seed = int(config.get("seed", 0))
    np.random.seed(seed)
    random.seed(seed)

    out_dir = config.get("out_dir") or "./results/{}/".format(
        os.path.splitext(os.path.basename(args.yaml))[0])
    os.makedirs(os.path.join(out_dir, "model"), exist_ok=True)
    logger = Logger(os.path.join(out_dir, "log_eval"))
    sys.stdout = logger
    try:
        if config["net"] == "LGCANet_V3":
            return eval_lgca(config, device, out_dir, seed)
        sampler = EpisodeSampler(config["data_dir"], config["eval_set_name"],
                                 config)
        print(f"[length of eval loader {len(sampler)}]")
        runner = build_runner(config, device, seed)
        if config.get("debug_nans"):
            models = runner.models   # one model a distinct device of the mesh
            enable_nan_debugging(True, models[0] if len(models) == 1
                                 else torch.nn.ModuleList(models))
        n_runs = args.n_runs or config.get("n_runs", 1)
        return run_eval_protocol(runner, sampler, config, out_dir, n_runs)
    finally:
        if config.get("debug_nans"):
            enable_nan_debugging(False)
        sys.stdout = logger.terminal
        logger.close()


def eval_lgca(config: Config, device, out_dir: str, seed: int = 0) -> Dict:
    """LGCANet_V3 whole-volume eval over the eval split
    (``rpnet_tpu/cli/test_rpnet.py:326-382``): a line ``{j} {pid} {roi}
    {dice} ...`` a volume (None for an ROI the volume lacks), a failed
    volume logged, counted and skipped, then each ROI's mean and std over
    volumes; ``results_eval.json`` holds them with the volume counts and
    the volumes/s."""
    sampler = LGCAVolumeSampler(config["data_dir"], config["eval_set_name"],
                                config, mode="eval")
    print(f"[length of LGCA eval loader {len(sampler)}]")
    model = build_lgcanet(config, seed=seed, device=device)
    load_checkpoint_into(model, config)
    mesh = sharding_mesh(resolve_cli_mesh(config.get("mesh_shape"), device, prefix="LGCA "))
    if config.get("debug_nans"):
        enable_nan_debugging(True, model)

    rois = list(config["roi_names"])
    per_class = defaultdict(list)
    failures = 0
    t0 = time.time()
    for j in range(len(sampler)):
        try:
            s = sampler.sample(j)
            dices = evaluate_lgca_volume(model, s, device, mesh=mesh)
        except Exception:
            failures += 1
            print(f"{j} VOLUME FAILED — skipping:\n{traceback.format_exc()}")
            continue
        print(f"{j} {s['pid']} " + " ".join(f"{rois[k]} {dices[f'class_{k}']}"
                                            for k in range(len(rois))))
        for k in range(len(rois)):
            if dices[f"class_{k}"] is not None:
                per_class[rois[k]].append(dices[f"class_{k}"])
    wall = time.time() - t0
    if failures:
        print(f"[{failures} volume(s) failed]")

    results: Dict = {"classes": {}, "wall_time_sec": wall, "volumes": len(sampler),
                     "failed_volumes": failures,
                     "volumes_per_sec": (len(sampler) - failures) / max(wall, 1e-9)}
    print("=======Average performance=========")
    for roi in rois:
        vals = per_class[roi]
        m = float(np.mean(vals)) if vals else float("nan")
        sd = float(np.std(vals)) if vals else float("nan")
        print(f"{roi}, dice {m} + {sd}")
        results["classes"][roi] = {"dice": [m, sd]}
    with open(os.path.join(out_dir, "results_eval.json"), "w") as fjson:
        json.dump(results, fjson, indent=2)
    return results


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
    eval_fn = evaluate_3d if config.get("eval_3d") else evaluate
    for i in range(n_runs):
        print(f"{i + 1} / {n_runs}")
        t_pass = time.time()
        a, f, r, failures = eval_fn(runner, sampler, config)
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
