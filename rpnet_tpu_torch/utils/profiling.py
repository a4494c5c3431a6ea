"""Stage timing, profiler traces and NaN debugging.

The counterpart of ``rpnet_tpu/utils/profiling.py:30-108``:

  * :class:`StageTimer` — per-stage wall time, fenced on the device where a
    stage names its outputs, reported as one ``stage_timing`` line;
  * :func:`trace` — ``torch.profiler`` over the CPU (and CUDA where there is
    a card) writing a Chrome trace under a directory;
  * :func:`summarize_trace` — device time by operation from the newest such
    trace; :func:`device_events` / :func:`device_ms` are the same device-row
    filter over a live profiler's ``key_averages()``;
  * :func:`enable_nan_debugging` — the ``debug_nans`` switch: autograd's
    anomaly detection with its NaN check, and forward hooks that raise
    ``FloatingPointError`` at the first module whose output holds a NaN.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import torch

# Chrome-trace categories of work on the device (kernels and copies): the
# rows that take the place of an XLA device's "XLA Ops" timeline
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _first_cuda_device(obj) -> Optional[torch.device]:
    if isinstance(obj, torch.Tensor):
        return obj.device if obj.is_cuda else None
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        for o in obj:
            d = _first_cuda_device(o)
            if d is not None:
                return d
    return None


class StageTimer:
    """Accumulates per-stage wall time; device work fenced explicitly.

    >>> timer = StageTimer()
    >>> with timer.stage("registration", block_on=out):
    ...     out = fn(...)
    >>> print(timer.report())

    ``block_on`` (a tensor, or a list, tuple or dict holding tensors): at the
    stage's end the host waits for its card (``torch.cuda.synchronize``)
    when it holds a CUDA tensor; CPU work is done when it returns."""

    def __init__(self):
        self.totals: Dict[str, float] = collections.defaultdict(float)
        self.counts: Dict[str, int] = collections.defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            device = _first_cuda_device(block_on)
            if device is not None:
                torch.cuda.synchronize(device)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        parts = [f"{k}={self.totals[k]:.3f}s/{self.counts[k]}x"
                 for k in sorted(self.totals, key=self.totals.get, reverse=True)]
        return "stage_timing " + " ".join(parts)

    def as_dict(self) -> Dict[str, float]:
        return dict(self.totals)


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace(dir): run()`` → a Chrome trace ``*.pt.trace.json`` under
    ``dir`` (CPU operators, and CUDA kernels and copies where there is a
    card); yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"{os.getpid()}.{time.time_ns()}.pt.trace.json"))
    print(f"[profiler] trace written to {log_dir}")


def summarize_trace(log_dir: str, top: int = 20) -> List[Tuple[str, float, int]]:
    """Aggregate device-operation durations from the newest trace under
    ``log_dir`` (``*.trace.json`` or ``*.trace.json.gz``). Returns
    [(name, total_ms, count)] sorted by time.

    Only events of the ``DEVICE_CATEGORIES`` (kernels, copies and memsets
    on the card) are counted; where the trace has none (a CPU run), all
    complete events are."""
    files = [f for f in glob.glob(os.path.join(log_dir, "**", "*.trace.json*"),
                                  recursive=True)
             if f.endswith((".trace.json", ".trace.json.gz"))]
    if not files:
        raise FileNotFoundError(f"no trace.json under {log_dir}")
    newest = max(files, key=os.path.getmtime)
    opener = gzip.open if newest.endswith(".gz") else open
    with opener(newest, "rt") as f:
        events = json.load(f).get("traceEvents", [])
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    device = [e for e in complete if e.get("cat") in DEVICE_CATEGORIES]
    agg = collections.Counter()
    cnt = collections.Counter()
    for e in device or complete:
        agg[e.get("name", "?")] += e["dur"]
        cnt[e.get("name", "?")] += 1
    return [(name, dur / 1000.0, cnt[name]) for name, dur in agg.most_common(top)]


def device_ms(e) -> float:
    """A ``key_averages()`` entry's own device time in ms."""
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) / 1e3


def device_events(prof) -> list:
    """The device rows of a live profiler: ``key_averages()`` entries of
    kernels and copies on the card with device time (an operator's own
    entry may also carry its kernels' time, so operators are left out)."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and device_ms(e) > 0]


_nan_hooks: List = []


def _raise_on_nan(name: str):
    def hook(module, args, out):
        tensors = [out] if isinstance(out, torch.Tensor) else (
            list(out.values()) if isinstance(out, dict) else
            list(out) if isinstance(out, (list, tuple)) else [])
        for t in tensors:
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and bool(torch.isnan(t).any())):   # waits for the device
                raise FloatingPointError(
                    f"NaN in the output of {name} ({type(module).__name__})")
    return hook


def enable_nan_debugging(enable: bool = True, model: Optional[torch.nn.Module] = None):
    """The ``debug_nans`` switch (the JAX package flips ``jax_debug_nans``).

    Turns autograd's anomaly detection on (``check_nan``: a backward that
    returns a NaN raises, naming its function and the forward call that
    made it) and, given ``model``, adds forward hooks to every module that
    raise ``FloatingPointError`` naming the first module whose output holds a
    NaN. Each hook waits for the device: a debug switch, not for timing.
    ``enable=False`` turns both off and removes the hooks."""
    torch.autograd.set_detect_anomaly(enable, check_nan=True)
    while _nan_hooks:
        _nan_hooks.pop().remove()
    if enable and model is not None:
        for name, module in model.named_modules():
            _nan_hooks.append(module.register_forward_hook(
                _raise_on_nan(name or type(model).__name__)))

