"""Each cell end to end at a tiny size on the CPU (the kernels' plain
versions): set-up, the window, the check, the result's keys; a traced run
reads its per-layer metrics from the trace."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT, manifest, run_tiny

CELLS = ["rpnet_unet.eval.liver8", "lgca_v3.train", "rpnet_unet.train", "lgca_v3.eval"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(name, tmp_path):
    res = run_tiny(name, tmp_path)
    assert list(res)[-1] == "checks" and res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    bench = manifest()
    want = {m["name"] for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]}
    assert set(res["metrics"]) == want
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert res["device"]["platform"] == "cpu"   # never reported as a device reading


@pytest.mark.parametrize("name", ["rpnet_unet.eval.liver8", "lgca_v3.train"])
def test_traced_cell_reads_its_layers(name, tmp_path):
    res = run_tiny(name, tmp_path, trace=True)
    assert res["correct"] and "breakdown" in res
    assert res["device"]["window_s"] > 0
    # on the CPU the trace holds no device rows: the readers of device
    # shares return nothing, the host spans are read
    bench = manifest()
    hosts = {m["name"] for m in bench["per_layer"] if m["source"] == "program_span"
             and name in m["workloads"]}
    assert hosts and hosts <= set(res["metrics"])
    assert not any(k.startswith(("idle_share", "corr_")) for k in res["metrics"])


def test_no_card_no_result(tmp_path):
    """Without a CUDA device the command exits non-zero and prints no result."""
    proc = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                           "rpnet_unet.eval.liver8", "--seed", "3", "--seconds", "1",
                           "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "lgca_v3.eval", "--seed", "3", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_cell_added_from_data_files_only(tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric, added as
    files and manifest entries only, are found by name and run."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = manifest()
    with open(os.path.join(BENCH, "configs", "lgca_v3.json")) as f:
        config = json.load(f)
    config.update(num_slice=32, num_x=32, num_y=32, roi_names=["Liver", "Spleen"])
    (root / "benchmark/configs/lgca_two_roi.json").write_text(json.dumps(config))
    with open(os.path.join(BENCH, "workloads", "lgca_eval.vol2.json")) as f:
        traffic = json.load(f)
    traffic.update(volume_shape=[30, 40, 40], volumes=3)
    (root / "benchmark/workloads/lgca_eval.vol3.json").write_text(json.dumps(traffic))
    (root / "benchmark/metrics/evaluate_ms.lgca_eval.py").write_text(
        "from _common import span_ms\n\n\ndef read(run):\n    return span_ms(run, 'evaluate')\n")
    bench["configs"].append({"name": "lgca_two_roi", "source": "https://example.org/x",
                             "file": "benchmark/configs/lgca_two_roi.json", "reduced": [],
                             "why": "a throwaway"})
    bench["workloads"].append({"name": "lgca_two_roi.eval", "config": "lgca_two_roi",
                               "traffic": "lgca_eval.vol3", "chips": 1, "why": "a throwaway"})
    for m in bench["end_to_end"]:
        if m["name"] == "volumes_per_s":
            m["workloads"].append("lgca_two_roi.eval")
    bench["per_layer"].append({"name": "evaluate_ms.lgca_eval", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "whole volume",
                               "moves": "volumes_per_s", "workloads": ["lgca_two_roi.eval"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    os.symlink(os.path.join(ROOT, "rpnet_tpu_torch"), root / "rpnet_tpu_torch")
    script = ("import sys, time, json; sys.path[:0] = ['benchmark', 'benchmark/metrics', '.']\n"
              "import run\n"
              "bench = run.manifest()\n"
              "wl, cfg, tr = run.cell_files('lgca_two_roi.eval', bench)\n"
              "for trace in (False, True):\n"
              "    res = run.run_cell(bench, wl, cfg, tr, 5, 0.5, trace, 'cpu', 'work', time.perf_counter())\n"
              "    print(json.dumps(res))\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=root, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    plain, traced = (json.loads(line) for line in proc.stdout.strip().splitlines()[-2:])
    assert plain["correct"] and plain["attempted"] == 3 and "volumes_per_s" in plain["metrics"]
    assert traced["correct"] and traced["metrics"]["evaluate_ms.lgca_eval"]["value"] > 0
