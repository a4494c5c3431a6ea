"""The benchmark's CPU tests: ``python -m pytest benchmark/tests -q`` from
the repository root. They run the harness on the CPU at tiny sizes with the
kernels' plain versions; nothing here needs a card."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, os.path.join(BENCH, "metrics"), BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

import json  # noqa: E402

# each cell at a size the CPU runs in seconds: narrow slices and volumes,
# few of them; every width of the models as configured
TINY = {
    "rpnet_unet.eval.liver8": (dict(num_x=64, num_y=64, crop_size=[48, 48]),
                               dict(volume_shape=[16, 64, 64], liver_extents=[5, 7, 6])),
    "lgca_v3.train": (dict(num_slice=32, num_x=32, num_y=32),
                      dict(volume_shape=[30, 40, 40], volumes=2, trace_steps=2)),
    "rpnet_unet.train": (dict(num_x=64, num_y=64, crop_size=[48, 48]),
                         dict(volume_shape=[16, 64, 64], trace_steps=2,
                              extents={"Spleen": [5, 6, 7], "Kidney L": [6, 7, 8],
                                       "Kidney R": [5, 7, 6]})),
    "lgca_v3.eval": (dict(num_slice=32, num_x=32, num_y=32), dict(volume_shape=[30, 40, 40])),
}


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def tiny_cell(name, bench_dir=BENCH):
    """(manifest, cell entry, configuration, traffic) of ``name``, cut to TINY."""
    import run

    bench = manifest()
    wl, config, traffic = run.cell_files(name, bench)
    config.update(TINY[name][0])
    traffic.update(TINY[name][1])
    return bench, wl, config, traffic


def run_tiny(name, tmp_path, trace=False, seed=2 ** 31 + 11):
    import time

    import run

    bench, wl, config, traffic = tiny_cell(name)
    return run.run_cell(bench, wl, config, traffic, seed, 0.5, trace, "cpu",
                        str(tmp_path / "work"), time.perf_counter())


def cell_on_cpu(name, tmp_path, seed=2 ** 31 + 11):
    """A tiny cell's driver after set-up and a short window, on the CPU."""
    import harness
    import run
    import torch

    bench, wl, config, traffic = tiny_cell(name)
    driver = run.load_module(os.path.join(BENCH, "drivers", f"{traffic['entry']}.py"),
                             f"driver_{traffic['entry']}")
    work = tmp_path / "work"
    work.mkdir()
    cell = driver.Cell(harness.Run(wl, config, traffic, seed, 0.5, False, torch.device("cpu"),
                                   str(work)))
    cell.setup()
    cell.window()
    return cell
