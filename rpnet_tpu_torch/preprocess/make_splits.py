"""Generate split + class CSVs for any preprocessed NRRD dataset.

The port's copy of ``rpnet_tpu/preprocess/make_splits.py``; the port imports nothing
of the JAX package.

The episodic pipeline needs three metadata artifacts (few_shot_reader.py:
352-371 semantics): a train split (one pid per line), a test split, and a
per-ROI class CSV ``pid,z_start,z_end,path``. The reference produced them in
a notebook that is not in its repo (README.md:12; ``*.ipynb`` gitignored) —
this tool computes them from the data itself, for ANY dataset in the
standard layout (``{pid}_clean.nrrd`` + ``{pid}_{roi}.nrrd``): Abd-110 CT,
brain MRI (BASELINE config 4's cross-modality path), or synthetic volumes.

    python -m rpnet_tpu_torch.preprocess.make_splits \
        --data-dir /data/brain --out-dir /data/brain_meta --test-frac 0.2

Afterwards the standard eval CLI runs on that dataset:
    data_dir: /data/brain
    class_csv_dir: /data/brain_meta/classes
    eval_set_name: /data/brain_meta/test.csv
"""

from __future__ import annotations

import argparse
import os
import random
from typing import Dict, List, Sequence, Tuple

from rpnet_tpu_torch.preprocess.abd110 import write_class_csvs


def discover(data_dir: str) -> Tuple[List[str], List[str]]:
    """Scan a standard-layout directory → (pids, roi_names)."""
    pids, rois = set(), set()
    for f in os.listdir(data_dir):
        if f.endswith("_clean.nrrd"):
            pids.add(f[: -len("_clean.nrrd")])
    # LONGEST-prefix match, iterated in deterministic (length-desc, lexical)
    # order: with pids 'case1' and 'case1_followup', mask
    # 'case1_followup_liver.nrrd' must resolve to roi 'liver', identically
    # on every run (a set-ordered first match was nondeterministic)
    by_len = sorted(pids, key=lambda p: (-len(p), p))
    for f in os.listdir(data_dir):
        if f.endswith(".nrrd") and not f.endswith("_clean.nrrd") \
                and not f.endswith("_masks.nrrd"):
            stem = f[: -len(".nrrd")]
            for pid in by_len:
                if stem.startswith(pid + "_"):
                    rois.add(stem[len(pid) + 1:])
                    break
    return sorted(pids), sorted(rois)


def make_splits(data_dir: str, out_dir: str, test_frac: float = 0.2,
                seed: int = 0,
                roi_names: Sequence[str] | None = None) -> Dict[str, str]:
    """Write train.csv / test.csv / classes/{roi}.csv; returns their paths.

    The split is a seeded shuffle (deterministic for a given seed and pid
    set), mirroring the 87/24 patient-level split shipped for Abd-110.
    """
    pids, found_rois = discover(data_dir)
    if not pids:
        raise ValueError(f"no '*_clean.nrrd' volumes under {data_dir}")
    rois = list(roi_names) if roi_names else found_rois
    if not rois:
        raise ValueError(f"no '{{pid}}_{{roi}}.nrrd' masks under {data_dir}")

    rng = random.Random(seed)
    shuffled = list(pids)
    rng.shuffle(shuffled)
    n_test = max(1, int(round(len(shuffled) * test_frac)))
    test, train = shuffled[:n_test], shuffled[n_test:]

    os.makedirs(out_dir, exist_ok=True)
    train_csv = os.path.join(out_dir, "train.csv")
    test_csv = os.path.join(out_dir, "test.csv")
    with open(train_csv, "w") as f:
        f.write("\n".join(sorted(train)) + "\n")
    with open(test_csv, "w") as f:
        f.write("\n".join(sorted(test)) + "\n")

    class_dir = os.path.join(out_dir, "classes")
    write_class_csvs(data_dir, class_dir, roi_names=rois)
    return {"train_csv": train_csv, "test_csv": test_csv,
            "class_dir": class_dir, "rois": rois,
            "n_train": len(train), "n_test": len(test)}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="split + class CSVs for a standard-layout NRRD dataset")
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--test-frac", type=float, default=0.2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rois", nargs="*", default=None,
                    help="restrict to these ROI names (default: discovered)")
    args = ap.parse_args(argv)
    res = make_splits(args.data_dir, args.out_dir, args.test_frac, args.seed,
                      args.rois)
    print(f"{res['n_train']} train / {res['n_test']} test pids; "
          f"classes: {', '.join(res['rois'])}")
    print(f"train: {res['train_csv']}\ntest: {res['test_csv']}\n"
          f"classes: {res['class_dir']}")


if __name__ == "__main__":
    main()
