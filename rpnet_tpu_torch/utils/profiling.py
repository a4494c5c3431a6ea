"""Spans of the program's work, stage timing and NaN debugging.

  * :class:`span` — a named span of the program's work (a context manager
    or a decorator), kept as one :class:`Span` record in :data:`SPANS`, a
    bounded ring that any code reads. Spans nest on each thread: a record
    names its parent and its unit (the outermost span open on its thread:
    an episode's, step's or volume's spans share it). Times are
    ``time.time_ns()``, the clock ``torch.profiler`` stamps its events
    with, so the records join a profiler trace. Given the device its work
    runs on, a span opened while a profiler records also takes a pair of
    CUDA events on that device's current stream; :meth:`Span.device_ms`
    reads the pair once the work is done. No span synchronises the
    device, and none is taken inside ``torch.export``'s tracing. The
    benchmark's per-layer metrics read spans by name (``PERF.md`` §3);
  * :class:`StageTimer` — per-stage wall time, fenced on the device where a
    stage names its outputs, reported as one ``stage_timing`` line (the
    counterpart of ``rpnet_tpu/utils/profiling.py:29-60``); each stage is
    also a span of its name;
  * :func:`enable_nan_debugging` — the ``debug_nans`` switch: autograd's
    anomaly detection with its NaN check, and forward hooks that raise
    ``FloatingPointError`` at the first module whose output holds a NaN.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple

import torch

SPANS_KEPT = 65536   # a long CLI run keeps its newest spans
SPANS: Deque["Span"] = collections.deque(maxlen=SPANS_KEPT)
_ids = itertools.count(1)
_open = threading.local()   # each thread's stack of open spans


class Span:
    """One closed span: ``name``, its ``id``, its ``parent``'s id (None at
    the top), its ``unit`` (the id of the outermost span open on its
    thread, its own at the top), the ``thread``, ``start_ns`` and
    ``end_ns`` (``time.time_ns()``), and ``events``, the (start, end) CUDA
    event pair where one was taken."""
    __slots__ = ("name", "id", "parent", "unit", "thread", "start_ns", "end_ns", "events")

    def __init__(self, name: str, parent: Optional["Span"]):
        self.name, self.id = name, next(_ids)
        self.parent = parent.id if parent is not None else None
        self.unit = parent.unit if parent is not None else self.id
        self.thread = threading.get_ident()
        self.events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = None
        self.end_ns = 0
        self.start_ns = time.time_ns()

    def device_ms(self) -> Optional[float]:
        """Device milliseconds between the span's events (waits for the end
        event: read once the work is done); None without a pair."""
        if self.events is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)


class span(contextlib.ContextDecorator):
    """``with span(name[, device]):`` or ``@span(name)``: one :class:`Span`
    in :data:`SPANS` when the block ends (module doc). ``device``: where the
    block's work runs; on a CUDA device, while a profiler records, the span
    takes its event pair on that device's current stream."""
    __slots__ = ("name", "device", "record")

    def __init__(self, name: str, device: Optional[torch.device] = None):
        self.name, self.device, self.record = name, device, None

    def _recreate_cm(self):   # a decorated function opens a span of its own a call
        return span(self.name, self.device)

    def __enter__(self):
        if torch.compiler.is_compiling():   # torch.export traces the program: no span
            return self
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        rec = self.record = Span(self.name, stack[-1] if stack else None)
        d = self.device
        if d is not None and d.type == "cuda" and torch._C._autograd._profiler_enabled():
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record(torch.cuda.current_stream(d))
        stack.append(rec)
        return self

    def __exit__(self, *exc):
        rec = self.record
        if rec is None:
            return False
        self.record = None
        _open.stack.pop()
        if rec.events is not None:
            rec.events[1].record(torch.cuda.current_stream(self.device))
        rec.end_ns = time.time_ns()
        SPANS.append(rec)
        return False


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
            with span(name):
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

