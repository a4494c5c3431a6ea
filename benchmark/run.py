"""Run one cell of the benchmark once and print its result.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration (its file under ``benchmark/configs/``) and a traffic
mix (``benchmark/workloads/<traffic>.json``), whose ``entry`` names the
driver (``benchmark/drivers/<entry>.py``) that builds the program's objects,
warms them, runs the window and checks what it produced against the plain
reference (``benchmark/reference/``). ``--trace 1`` runs a fixed amount
of the cell's work instead, once plainly and once under the profiler, and
reports the cell's per-layer metrics, each read by
``benchmark/metrics/<metric>.py``.

The last line of standard output is the result (JSON); the compared
numbers, each beside its limit, are the last lines of standard error. A run
needs a CUDA device (as many as the cell asks for) and exits non-zero
without printing a result where there is none, where the program cannot be
imported, or where the process holds a module of the JAX stack or the JAX
package once the window has closed. Build and kernel caches stay under the
checkout's ``build/``; the volumes a run writes go under ``$TMPDIR``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()   # set-up is timed from here

import argparse
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import traceback

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)
sys.path.insert(0, os.path.join(BENCH, "metrics"))   # the readers share _common.py

import harness  # noqa: E402


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_files(name: str, bench: dict):
    """The cell's manifest entry, its configuration and its traffic mix."""
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    with open(os.path.join(ROOT, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(BENCH, "workloads", f"{wl['traffic']}.json")) as f:
        traffic = json.load(f)
    return wl, config, traffic


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports the end-to-end ``metric``."""
    return "workloads" not in metric or cell in metric["workloads"]


def run_cell(bench: dict, wl: dict, config: dict, traffic: dict, seed: int, seconds: float,
             trace: bool, device, workdir: str, t_start: float) -> dict:
    """Set up, run the window, read the peak, check → the result's dict."""
    import torch

    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    run = harness.Run(wl, config, traffic, seed, seconds, trace, torch.device(device), workdir)
    on_card = run.device.type == "cuda"
    try:
        driver = load_module(os.path.join(BENCH, "drivers", f"{traffic['entry']}.py"),
                             f"driver_{traffic['entry']}")
        cell = driver.Cell(run)
        cell.setup()
        if on_card:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        run.spans.clear()
        cell.window()
        peak = torch.cuda.max_memory_allocated(run.device) if on_card else 0
        checks = cell.check()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    metrics = {}
    if not trace:
        run.metrics["setup_s"] = setup_s
        for name, value in run.metrics.items():
            if name in e2e and reports(e2e[name], wl["name"]):
                metrics[name] = {"value": value, "unit": units[name]}
    else:
        for m in bench["per_layer"]:
            if wl["name"] not in m["workloads"]:
                continue
            reader = load_module(os.path.join(BENCH, "metrics", f"{m['name']}.py"),
                                 f"metric_{m['name']}")
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(run.device) if on_card else "cpu",
           "count": int(wl["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": all(v <= lim for v, lim in checks.values()) and run.failed == 0,
              "attempted": run.attempted, "failed": run.failed, "metrics": metrics,
              "device": dev}
    if trace and run.trace_data is not None:
        dev["busy_s"] = run.trace_data.busy_s
        dev["window_s"] = run.trace_data.window_s
        dev["window_unprofiled_s"] = run.plain_window_s
        result["breakdown"] = run.trace_data.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    bench = manifest()
    wl, config, traffic = cell_files(args.workload, bench)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(wl["chips"]):
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import rpnet_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is not in this checkout: {e}", file=sys.stderr)
        return 2
    workdir = os.path.join(tempfile.gettempdir(), "rpnet_bench", args.workload)
    try:
        result = run_cell(bench, wl, config, traffic, args.seed, args.seconds, bool(args.trace),
                          "cuda:0", workdir, T_START)
    except Exception:
        traceback.print_exc()
        return 1
    bad = harness.forbidden_modules()
    if bad:
        print(f"the process holds {', '.join(bad)}: no result", file=sys.stderr)
        return 3
    dev = result["device"]
    if "window_s" in dev:   # the profiler's stretch of the same work
        print(f"wall {dev['window_unprofiled_s']!r} s unprofiled, {dev['window_s']!r} s profiled, "
              f"busy {dev['busy_s']!r} s", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
