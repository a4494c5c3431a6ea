"""BENCHMARK.json against the benchmark's contract, and the files it names."""

import json
import os
import re

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_names_and_units():
    b = manifest()
    assert set(b) == TOP
    assert b["command"] == ["python3", "benchmark/run.py"] and b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200 and w["config"] in names
        assert NAME.match(w["traffic"])
        names.append(w["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in [e["name"] for e in b["end_to_end"]]
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_every_named_file_is_there():
    b = manifest()
    for c in b["configs"]:
        assert c["file"].startswith("benchmark/") and os.path.isfile(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    for w in b["workloads"]:
        with open(os.path.join(BENCH, "workloads", f"{w['traffic']}.json")) as f:
            entry = json.load(f)["entry"]
        assert os.path.isfile(os.path.join(BENCH, "drivers", f"{entry}.py"))
    for m in b["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH, "metrics", f"{m['name']}.py"))


def test_every_cell_reports_enough():
    b = manifest()
    for w in b["workloads"]:
        e2e = [m["name"] for m in b["end_to_end"] if "workloads" not in m or w["name"] in m["workloads"]]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = [m for m in b["per_layer"] if w["name"] in m.get("workloads", [])
                 or ("workloads" not in m and m["moves"] in e2e)]
        assert layer and all(m["moves"] in e2e for m in layer)


def test_a_full_check_fits_its_time_with_24_cells():
    b = manifest()
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
