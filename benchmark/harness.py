"""The benchmark's common machinery: a run's context, the host-clock spans
the harness records around its calls into the program, the profiler trace
of a traced window and its reduction, the seeds, and the import check."""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

# whole top-level module names that no run may hold (the JAX stack and the
# JAX package; ``rpnet_tpu_torch`` is another name)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "rpnet_tpu")
NAME_CHARS = 160   # a device operation's name in the breakdown, cut


def forbidden_modules(modules=None) -> List[str]:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


# keys of a configuration file that describe it rather than configure the program
DESCRIPTIVE_KEYS = ("source", "reduced", "assumed", "deployment")


def program_keys(config: dict) -> dict:
    """The configuration file's keys that the program reads."""
    return {k: v for k, v in config.items() if k not in DESCRIPTIVE_KEYS}


def seeds(seed: int) -> Dict[str, int]:
    """Independent streams from one ``--seed`` of any size: the device
    generator's, numpy's (32 bits), stdlib ``random``'s and the sample of
    answers that the check compares."""
    s = np.random.SeedSequence(int(seed)).generate_state(4, dtype=np.uint32)
    return {"torch": int(s[0]), "numpy": int(s[1]), "random": int(s[2]), "check": int(s[3])}


class Spans:
    """Host-clock seconds of named calls; in a traced window each span is
    also a ``record_function`` range, so the trace can say what the host
    was doing while the device sat idle."""

    def __init__(self):
        self.seconds: Dict[str, List[float]] = defaultdict(list)
        self.tracing = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        import torch

        rf = torch.profiler.record_function(name) if self.tracing else contextlib.nullcontext()
        t0 = time.perf_counter()
        with rf:
            yield
        self.seconds[name].append(time.perf_counter() - t0)

    def clear(self):
        self.seconds.clear()


@dataclasses.dataclass
class Trace:
    """A traced window: device operations and harness spans as (start ns,
    end ns, name), on the profiler's clock, and the window's bounds."""
    device: List[Tuple[int, int, str]]
    host: List[Tuple[int, int, str]]
    t0: int
    t1: int

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        for s, e, _ in sorted(self.device):
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def seconds_of(self, match) -> Tuple[float, int]:
        """Summed device seconds and count of the operations whose name
        ``match`` accepts."""
        hits = [(e - s) for s, e, n in self.device if match(n)]
        return sum(hits) * 1e-9, len(hits)

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, summed by name, and
        the idle time of the device summed by the innermost harness span
        the host was in at each gap's middle (``other`` outside them)."""
        by_op: Dict[str, float] = defaultdict(float)
        for s, e, n in self.device:
            by_op[n[:NAME_CHARS]] += (e - s) * 1e-9
        gaps: Dict[str, float] = defaultdict(float)
        edges = [self.t0] + [t for iv in self.busy_intervals() for t in iv] + [self.t1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            inside = [(e - s, n) for s, e, n in self.host if s <= mid < e]
            gaps[min(inside)[1] if inside else "other"] += (b - a) * 1e-9
        order = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": order(by_op), "idle_gaps": order(gaps)}


@contextlib.contextmanager
def traced(spans: Spans, holder: dict):
    """Profile the block on the CPU and the card; on exit put its
    :class:`Trace` in ``holder["trace"]``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.cuda.is_available()
    prof = profile(activities=[ProfilerActivity.CPU]
                   + ([ProfilerActivity.CUDA] if on_card else []))
    prof.start()
    spans.tracing = True
    try:
        with spans("window"):
            yield
            if on_card:
                torch.cuda.synchronize()
    finally:
        spans.tracing = False
        prof.stop()
    names = set(spans.seconds)
    device, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        name, on_device = e.name(), e.device_type() == cuda
        if on_device == (name in names):   # a span's range on the card's timeline, or neither
            continue
        start = e.start_ns()
        (device if on_device else host).append((start, start + e.duration_ns(), name))
    t0, t1 = next((s, e) for s, e, n in host if n == "window")
    host = [h for h in host if h[2] != "window"]
    holder["trace"] = Trace(device, host, t0, t1)


def traced_work(run: "Run", work) -> None:
    """A traced run's fixed ``work``, twice: first under the profiler (the
    trace; the check's captures fall in it), then plainly, timed by the
    host clock with its spans kept (the wall that the idle share and the
    MFU divide by, and the host spans' metrics, free of the profiler's
    overhead)."""
    import torch

    sync = torch.cuda.synchronize if run.device.type == "cuda" else (lambda: None)
    holder = {}
    with traced(run.spans, holder):
        work()
    run.trace_data = holder["trace"]
    run.spans.clear()
    sync()
    t0 = time.perf_counter()
    work()
    sync()
    run.plain_window_s = time.perf_counter() - t0
    run.plain_spans = {k: list(v) for k, v in run.spans.seconds.items()}


@contextlib.contextmanager
def tf32(matmul: bool, cudnn: bool):
    """Matrix products and cuDNN convolutions in TF32 or not inside the
    block, as asked, then as before."""
    import torch

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def full_f32():
    """Full f32 inside the block: the references run so."""
    return tf32(matmul=False, cudnn=False)


def torch_defaults():
    """torch's default precision inside the block, as the program runs:
    cuDNN convolutions in TF32, matrix products in f32 (a witness of what
    rounding alone moves)."""
    return tf32(matmul=False, cudnn=True)


@dataclasses.dataclass
class Run:
    """One run of one cell: what the harness was asked, what the driver
    measured, and what the per-layer readers read."""
    workload: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    workdir: str
    spans: Spans = dataclasses.field(default_factory=Spans)
    metrics: Dict[str, float] = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    # the traced window, the same work's plain wall and spans, and the work
    # each held as the benchmark counts it
    trace_data: Optional[Trace] = None
    plain_window_s: Optional[float] = None
    plain_spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    work_flops: Optional[float] = None     # FLOPs the window's work needs
    peak_unit: Optional[str] = None        # the roofline.PEAK_FLOPS unit it is held to
    corr_calls: List[tuple] = dataclasses.field(default_factory=list)  # (shape, r, dtype, backward)


def p95(values) -> float:
    return float(np.percentile(np.asarray(values, np.float64), 95))
