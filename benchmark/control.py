"""Readings that set a cell's limits: for each seed, one short window of the
cell, then its numbers twice, the program against the reference and the
control (the reference a step below the configuration's precisions, as the
cell's driver states them) against the reference.

    python benchmark/control.py --workload <name> --seconds 5 --seeds 1 2 3

Prints one JSON line a seed. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import run as bench_run


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--witness", action="store_true",
                   help="also read the reference at torch's default precision in the program's place")
    p.add_argument("--control-seeds", type=int, default=None,
                   help="read the control and the faults on the first N seeds only")
    args = p.parse_args(argv)
    import harness
    import torch

    sys.path.insert(0, bench_run.ROOT)
    bench = bench_run.manifest()
    wl, config, traffic = bench_run.cell_files(args.workload, bench)
    driver = bench_run.load_module(os.path.join(bench_run.BENCH, "drivers", f"{traffic['entry']}.py"),
                                   "driver")
    for i, seed in enumerate(args.seeds):
        with_control = args.control_seeds is None or i < args.control_seeds
        workdir = os.path.join(tempfile.gettempdir(), "rpnet_control", args.workload)
        shutil.rmtree(workdir, ignore_errors=True)
        os.makedirs(workdir)
        run = harness.Run(wl, config, traffic, seed, args.seconds, False, torch.device(args.device),
                          workdir)
        t0 = time.perf_counter()
        cell = driver.Cell(run)
        cell.setup()
        cell.window()
        t1 = time.perf_counter()
        program = cell.check()
        details = [getattr(cell, "details", None)]
        t2 = time.perf_counter()
        control, faults = {}, None
        if with_control:
            control = cell.check(control=True)
            details.append(getattr(cell, "details", None))
            faults = cell.fault_readings() if hasattr(cell, "fault_readings") else None
            if args.witness:
                faults = dict(faults or {}, witness=cell.witness_readings())
        print(json.dumps({"seed": seed, "program": {k: v for k, (v, _) in program.items()},
                          "control": {k: v for k, (v, _) in control.items()}, "faults": faults,
                          "metrics": run.metrics, "failed": run.failed, "details": details,
                          "seconds": [t1 - t0, t2 - t1, time.perf_counter() - t2]}), flush=True)
        shutil.rmtree(workdir, ignore_errors=True)
        del cell
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
