#!/usr/bin/env python3
"""Warm eval passes of checkouts of this repository, in turns, on one GPU.

    git archive <commit> | (mkdir -p build/parent && tar -x -C build/parent)
    python3 tools/eval_ab.py build/parent tree tree,device_volume_cache=0,num_workers=0

Each source runs the port's eval CLI (``python -m
rpnet_tpu_torch.cli.test_rpnet``, its own process, from its own checkout) on
``chip_smoke.py``'s main-path data (4 synthetic Liver volumes of 48×272×272,
seed 0, written once under ``build/eval_ab/``) with ``yamls/example.yml``
(256², U-Net, r=5, 10 refinement iterations, bf16) for ``--runs`` passes. A
source is ``tree`` (this checkout) or a path to another checkout, optionally
followed by ``,key=value`` config overrides (YAML values). The sources run
in turns, the order reversed every other turn (A B C, C B A, ...). Printed
per run: every pass's ``pass_wall`` and ``stage_timing`` line; per source:
the warm passes' (the 2nd on) walls and episodes/s. The card's name and
power limit come first.
"""

from __future__ import annotations

import argparse
import os
import re
import statistics
import subprocess
import sys

import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(ROOT, "build", "eval_ab")


def parse_source(text: str):
    path, *pairs = text.split(",")
    tree = ROOT if path == "tree" else os.path.abspath(path)
    return tree, {k: yaml.safe_load(v) for k, v in (p.split("=", 1) for p in pairs)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("sources", nargs="+")
    ap.add_argument("--runs", type=int, default=4, help="passes a run (n_runs)")
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        raise SystemExit(f"nvidia-smi failed: {smi.stderr}")
    print(f"gpu {smi.stdout.strip()}", flush=True)

    sys.path.insert(0, ROOT)
    from rpnet_tpu_torch.core.synthetic import generate_dataset

    paths = generate_dataset(os.path.join(WORK, "data"), n_train=1, n_test=4,
                             shape=(48, 272, 272), classes=("Liver",), seed=0)
    with open(os.path.join(ROOT, "yamls", "example.yml")) as f:
        base = yaml.safe_load(f)
    base.update(data_dir=paths["data_dir"], class_csv_dir=paths["class_dir"],
                eval_set_name=paths["test_csv"], train_set_name=paths["train_csv"],
                n_runs=args.runs)

    walls = {s: [] for s in args.sources}
    for turn in range(args.turns):
        order = args.sources if turn % 2 == 0 else args.sources[::-1]
        for src in order:
            tree, overrides = parse_source(src)
            tag = f"t{turn}_{args.sources.index(src)}"
            cfg = dict(base, out_dir=os.path.join(WORK, f"out_{tag}"), **overrides)
            ypath = os.path.join(WORK, f"{tag}.yml")
            with open(ypath, "w") as f:
                yaml.safe_dump(cfg, f)
            proc = subprocess.run([sys.executable, "-m", "rpnet_tpu_torch.cli.test_rpnet",
                                   "--yaml", ypath], cwd=tree, capture_output=True,
                                  text=True, env=dict(os.environ, PYTHONPATH=tree))
            if proc.returncode != 0:
                print(proc.stdout[-3000:], proc.stderr[-3000:])
                raise SystemExit(f"{src}: the eval CLI failed ({proc.returncode})")
            lines = proc.stdout.splitlines()
            timings = [l for l in lines if l.startswith("stage_timing")]
            passes = [l for l in lines if l.startswith("pass_wall")]
            if any("episode(s) failed" in l for l in lines) or len(passes) != args.runs:
                raise SystemExit(f"{src}: episodes failed or passes missing")
            for i, (t, w) in enumerate(zip(timings, passes)):
                print(f"[{src}] turn {turn} pass {i + 1}: {w}; {t}", flush=True)
                wall, n_eps = re.match(r"pass_wall ([\d.]+)s / (\d+) episodes", w).groups()
                if i:
                    walls[src].append((float(wall), int(n_eps)))
    for src, runs in walls.items():
        w = [x for x, _ in runs]
        print(f"[{src}] warm passes: wall median {statistics.median(w):.3f}s "
              f"(min {min(w):.3f}, max {max(w):.3f}, {len(w)} passes), episodes/s "
              f"{', '.join(f'{n / x:.3f}' for x, n in runs)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
