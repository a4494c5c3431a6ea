"""RP_Net on SAM's ViT encoder (``rpnet_sam_vitb.eval.liver8``): the cell
end to end at a tiny size on the CPU (set here; ``conftest.TINY`` stays as
it is), plain and traced, its two per-layer readers on a hand-built run,
the attention's bound, and the cell's quick failure on a program without
the backbone."""

import os
import sys
import time

import pytest
import torch

import attention_roofline
import harness
import roofline
import run as bench_run
from conftest import BENCH, manifest
from test_bench_program_spans import MS, Ring, make_run, read

SAM = "rpnet_sam_vitb.eval.liver8"
SMALL_VIT = dict(img_size=160, patch_size=16, embed_dim=64, depth=4, num_heads=4,
                 global_attn_indexes=[1, 3], window_size=4, out_chans=32)
# a 40² crop gives 10 features a side at scale 4, as 160/16 does; windows of
# 4 pad the 10-token grid to 12
SIZES = (dict(num_x=64, num_y=64, crop_size=[40, 40], sam_vit=SMALL_VIT),
         dict(volume_shape=[16, 64, 64], liver_extents=[5, 7, 6]))


def small_cell():
    bench = manifest()
    wl, config, traffic = bench_run.cell_files(SAM, bench)
    config.update(SIZES[0])
    traffic.update(SIZES[1])
    return bench, wl, config, traffic


def run_small(tmp_path, trace=False, seed=2 ** 31 + 29):
    bench, wl, config, traffic = small_cell()
    return bench_run.run_cell(bench, wl, config, traffic, seed, 0.5, trace, "cpu",
                              str(tmp_path / "work"), time.perf_counter())


def test_sam_cell_runs_and_is_correct(tmp_path):
    res = run_small(tmp_path)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    want = {m["name"] for m in manifest()["end_to_end"]
            if "workloads" not in m or SAM in m["workloads"]}
    assert set(res["metrics"]) == want == {"episodes_per_s", "episode_p95_ms", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())


def test_sam_cell_traced(tmp_path, capfd):
    res = run_small(tmp_path, trace=True)
    assert res["correct"] and "breakdown" in res
    # on the CPU no span takes device events: the device readers read nothing
    assert "encoder_ms.sam_eval" not in res["metrics"]
    assert "attn_roofline.sam_eval" not in res["metrics"]
    assert "dispatch_ms.eval" in res["metrics"]
    err = capfd.readouterr().err
    assert "attention entropy (mean, log N): windowed" in err and "global" in err


def test_sam_readers(monkeypatch):
    """Two episodes, each with one encoder span over three attention calls."""
    ring = Ring(monkeypatch)
    for s0, enc, attn in ((10, 60.0, (1.0, 2.0, 3.0)), (60, 80.0, (2.0, 2.0, 2.0))):
        d = ring.add("dispatch", s0, s0 + 40)
        n = ring.add("network", s0 + 5, s0 + 39, parent=d, device=enc + 10)
        e = ring.add("sam.encoder", s0 + 6, s0 + 30, parent=n, device=enc)
        for i, ms in enumerate(attn):
            ring.add("sam.attn", s0 + 7 + i, s0 + 7.5 + i, parent=e, device=ms)
    trace = harness.Trace([(int(10 * MS), int(100 * MS), "k")], [], 0, int(100 * MS))
    run = make_run(trace, {"dispatch": [0.04, 0.04]})
    assert read("encoder_ms.sam_eval", run) == pytest.approx(70.0)
    assert read("attn_roofline.sam_eval", run) is None           # no calls counted
    run.attn_calls = [(8, 12, 64, 64), (200, 12, 14, 64)]
    want = 100 * sum(map(attention_roofline.bound, run.attn_calls)) / 12e-3
    assert read("attn_roofline.sam_eval", run) == pytest.approx(want)
    monkeypatch.setattr(sys.modules["rpnet_tpu_torch.utils.profiling"], "SPANS",
                        type(ring.spans)())
    assert read("encoder_ms.sam_eval", run) is None
    assert read("attn_roofline.sam_eval", run) is None


def test_attention_bound_from_shapes():
    vit_b = dict(SMALL_VIT, img_size=1024, embed_dim=768, depth=12, num_heads=12,
                 global_attn_indexes=[2, 5, 8, 11], window_size=14, out_chans=256)
    calls = attention_roofline.calls(3, vit_b)
    assert calls.count((3, 12, 64, 64)) == 4 and calls.count((75, 12, 14, 64)) == 8
    # a global block: 4·4096²·64 per head for q·kᵀ and ·v, and 4·4096·64·64
    # for the two bias products, over the bf16 peak
    g = (1, 12, 64, 64)
    assert attention_roofline.flops(g) == 12 * (4.0 * 4096 ** 2 * 64 + 4.0 * 4096 * 64 * 64)
    assert attention_roofline.bound(g) == pytest.approx(
        attention_roofline.flops(g) / roofline.PEAK_FLOPS["bf16 tensor cores"])
    # a window of 196 tokens is bytes-bound: q, k, v and the output once
    w = (25, 12, 14, 64)
    assert attention_roofline.bound(w) == pytest.approx(
        4 * 25 * 12 * 196 * 64 * 2 / roofline.HBM_BYTES_PER_S)


def test_sam_cell_fails_at_once_without_the_backbone(tmp_path, monkeypatch):
    """The parent commit's program has no ``sam_vit``: the cell raises
    before a volume is made."""
    import rpnet_tpu_torch.models

    monkeypatch.setitem(sys.modules, "rpnet_tpu_torch.models.sam_vit", None)
    monkeypatch.delattr(rpnet_tpu_torch.models, "sam_vit", raising=False)
    _, wl, config, traffic = small_cell()
    driver = bench_run.load_module(os.path.join(BENCH, "drivers", "rpnet_sam_eval.py"),
                                   "driver_rpnet_sam_eval_parent")
    work = tmp_path / "work"
    work.mkdir()
    cell = driver.Cell(harness.Run(wl, config, traffic, 3, 0.5, False, torch.device("cpu"),
                                   str(work)))
    with pytest.raises(ImportError):
        cell.setup()
    assert not (work / "data").exists()
