"""The readers of the program's spans (``metrics/_program.py`` and the
metrics that use it) on a hand-built run: ring records and a trace on one
clock, with known device times, idle gaps and counts. The plain pass ends
at its N-th unit span; records made after it (the check's) are left out."""

import collections
import os

import pytest
import torch

import harness
import run as bench_run
from conftest import BENCH
from rpnet_tpu_torch.utils import profiling

MS = 1_000_000   # ns


class Pair:
    """A CUDA event pair's stand-in: ``elapsed_time`` in ms."""

    def __init__(self, ms):
        self.ms, self.waited = ms, False

    def synchronize(self):
        self.waited = True

    def elapsed_time(self, end):
        assert end.waited   # read only once the end event is done
        return end.ms


class Ring:
    """Records in the program's ring, made by hand: ``add(name, start, end)``
    in ms, nested under ``parent``, with an event pair of ``device`` ms."""

    def __init__(self, monkeypatch):
        self.spans = collections.deque(maxlen=profiling.SPANS_KEPT)
        monkeypatch.setattr(profiling, "SPANS", self.spans)

    def add(self, name, start, end, parent=None, device=None):
        rec = profiling.Span(name, parent)
        rec.start_ns, rec.end_ns = int(start * MS), int(end * MS)
        if device is not None:
            rec.events = (Pair(0.0), Pair(device))
        self.spans.append(rec)
        return rec


def read(name, run):
    return bench_run.load_module(os.path.join(BENCH, "metrics", f"{name}.py"),
                                 f"metric_{name}").read(run)


def make_run(trace, plain_spans):
    r = harness.Run({}, {}, {}, 1, 1.0, True, torch.device("cpu"), "")
    r.trace_data, r.plain_spans = trace, plain_spans
    return r


def test_training_readers(monkeypatch):
    ring = Ring(monkeypatch)
    # traced pass, window 0–100 ms: two steps, each after two samples
    # (each 10 ms); the device busy 25–40 and 65–100
    for s0 in (0, 50):
        ring.add("sample", s0, s0 + 10)
        ring.add("sample", s0 + 10, s0 + 20)
        step = ring.add("train.step", s0 + 20, s0 + 45)
        ring.add("registration", s0 + 21, s0 + 30, parent=step, device=7.0)
    trace = harness.Trace([(int(25 * MS), int(40 * MS), "k"), (int(65 * MS), int(100 * MS), "k")],
                          [], 0, int(100 * MS))
    # plain pass: two steps, samples of 3 and 5 ms, then the check's calls
    for s0 in (200, 300):
        ring.add("sample", s0, s0 + 3)
        ring.add("sample", s0 + 3, s0 + 8)
        step = ring.add("train.step", s0 + 8, s0 + 30)
        ring.add("registration", s0 + 9, s0 + 20, parent=step, device=100.0)
    ring.add("sample", 400, 450)
    ring.add("registration", 450, 460, device=100.0)
    run = make_run(trace, {"batch": [0.008, 0.008]})
    assert read("fit_ms.train", run) == pytest.approx(7.0)            # 2 × 7 over 2 steps
    assert read("sample_ms.train", run) == pytest.approx(8.0)         # (3 + 5) a step
    # gaps: 0–25 (middle 12.5 in the second sample), 40–65 (middle 52.5 in
    # the next step's first sample): 50 ms over 2 steps
    assert read("sample_idle_ms.train", run) == pytest.approx(25.0)
    # one step counted by the harness: the first plain step's samples alone
    assert read("sample_ms.train", make_run(trace, {"batch": [0.008]})) == pytest.approx(8.0)
    # more steps counted than the plain pass holds: nothing to read
    assert read("sample_ms.train", make_run(trace, {"batch": [0.008] * 3})) is None


def test_eval_readers(monkeypatch):
    ring = Ring(monkeypatch)
    for s0, (fit, net) in ((10, (90.0, 80.0)), (60, (110.0, 100.0))):
        ring.add("data", s0, s0 + 1)
        d = ring.add("dispatch", s0 + 1, s0 + 20)
        ring.add("registration", s0 + 2, s0 + 10, parent=d, device=fit)
        ring.add("network", s0 + 10, s0 + 19, parent=d, device=net)
    ring.add("registration", 150, 160, device=1000.0)       # after the window
    trace = harness.Trace([(int(10 * MS), int(100 * MS), "k")], [], 0, int(100 * MS))
    run = make_run(trace, {"dispatch": [0.01, 0.01]})
    assert read("fit_ms.eval", run) == pytest.approx(100.0)
    assert read("network_ms.eval", run) == pytest.approx(90.0)


def test_lgca_eval_readers(monkeypatch):
    ring = Ring(monkeypatch)
    v = ring.add("lgca.volume", 5, 95)                       # traced: one volume, 3 chunks
    for z in range(3):
        ring.add("lgca.context", 10 + z, 10.5 + z, parent=v, device=20.0)
    ring.add("lgca.fetch", 20, 60, parent=v)
    ring.add("lgca.dice", 60, 90, parent=v)
    for s0, (fetch, dice) in ((110, (300, 200)), (800, (500, 100))):   # plain: two volumes
        v = ring.add("lgca.volume", s0, s0 + 650)
        ring.add("lgca.fetch", s0 + 10, s0 + 10 + fetch, parent=v)
        ring.add("lgca.dice", s0 + 10 + fetch, s0 + 10 + fetch + dice, parent=v)
    ring.add("lgca.dice", 2000, 2900)                       # the check's
    trace = harness.Trace([(int(10 * MS), int(40 * MS), "k")], [], 0, int(100 * MS))
    run = make_run(trace, {"evaluate": [0.55, 0.55], "sample": [0.1, 0.1]})
    assert read("context_ms.lgca_eval", run) == pytest.approx(60.0)
    assert read("fetch_ms.lgca_eval", run) == pytest.approx(400.0)
    assert read("dice_ms.lgca_eval", run) == pytest.approx(150.0)


@pytest.mark.parametrize("name", ["fit_ms.eval", "network_ms.eval", "fit_ms.train",
                                  "sample_ms.train", "sample_idle_ms.train",
                                  "fetch_ms.lgca_eval", "dice_ms.lgca_eval",
                                  "context_ms.lgca_eval"])
def test_nothing_to_read(name, monkeypatch):
    """No trace, an empty ring, spans without event pairs or a device
    trace without device work, or a program that keeps no spans (as the
    parent commit's): None, and nothing raised."""
    trace = harness.Trace([], [], 0, int(100 * MS))
    counted = {"batch": [0.01], "evaluate": [0.01], "dispatch": [0.01]}
    assert read(name, make_run(None, counted)) is None
    ring = Ring(monkeypatch)
    assert read(name, make_run(trace, counted)) is None
    for unit in ("dispatch", "train.step", "lgca.volume"):
        ring.add(unit, 10, 20)
        ring.add(unit, 200, 210)
    for inner in ("registration", "network", "lgca.context"):
        ring.add(inner, 11, 12)
    assert read(name, make_run(trace, counted)) is None
    monkeypatch.delattr(profiling, "SPANS")
    assert read(name, make_run(trace, counted)) is None
