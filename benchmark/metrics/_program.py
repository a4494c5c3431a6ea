"""Shared arithmetic of the readers of the program's own spans
(``rpnet_tpu_torch.utils.profiling.SPANS``: one record a span, its times
on the profiler's clock, ``time.time_ns()``). A traced run does its fixed
work twice (``harness.traced_work``): device milliseconds (the CUDA event
pairs spans take while the profiler records) and idle gaps come from the
traced pass, the records that start inside the trace's window; host
milliseconds come from the plain pass that follows it, the records after
the window up to the end of its N-th unit span, N being the units the
harness counted in that pass, so that the program's calls from the cell's
check, later, are left out. Each reader returns None where its run holds
nothing to read, as where the program keeps no spans."""

from __future__ import annotations


def _records():
    try:
        from rpnet_tpu_torch.utils import profiling
    except ImportError:
        return None
    ring = getattr(profiling, "SPANS", None)
    return list(ring) if ring else None


def traced(run):
    """The records that start inside the traced window, or None."""
    t, recs = run.trace_data, _records()
    if t is None or recs is None:
        return None
    return [r for r in recs if t.t0 <= r.start_ns <= t.t1]


def plain(run, unit: str, counted: str):
    """(records of the plain pass, its units): the records after the traced
    window up to the end of the N-th ``unit`` span, N the harness's count
    of ``counted`` spans in the plain pass; None where they are not there."""
    t, recs = run.trace_data, _records()
    n = len(run.plain_spans.get(counted, ()))
    if t is None or recs is None or n == 0:
        return None
    after = sorted((r for r in recs if r.start_ns > t.t1), key=lambda r: r.start_ns)
    ends = [r.end_ns for r in after if r.name == unit]
    if len(ends) < n:
        return None
    return [r for r in after if r.end_ns <= ends[n - 1]], n


def device_ms(run, name: str, unit: str):
    """Device milliseconds of the ``name`` spans of the traced pass (their
    event pairs) per ``unit`` span there."""
    recs = traced(run)
    if recs is None:
        return None
    units = sum(r.name == unit for r in recs)
    ms = [r.device_ms() for r in recs if r.name == name]
    if not units or not ms or None in ms:
        return None
    return sum(ms) / units


def host_ms(run, name: str, unit: str, counted: str):
    """Host milliseconds of the ``name`` spans of the plain pass per unit."""
    got = plain(run, unit, counted)
    if got is None:
        return None
    recs, n = got
    ms = [(r.end_ns - r.start_ns) * 1e-6 for r in recs if r.name == name]
    return sum(ms) / n if ms else None


def idle_ms(run, name: str, unit: str):
    """Milliseconds of the traced pass's device idle gaps whose middle lies
    in a ``name`` span as the innermost span of the program there (as
    ``Trace.breakdown`` gives gaps to the harness's spans), per ``unit``
    span."""
    t, recs = run.trace_data, traced(run)
    if recs is None or not t.device:
        return None
    units = sum(r.name == unit for r in recs)
    if not units:
        return None
    edges = [t.t0] + [x for iv in t.busy_intervals() for x in iv] + [t.t1]
    total = 0
    for a, b in zip(edges[0::2], edges[1::2]):
        mid = (a + b) // 2
        inside = [(r.end_ns - r.start_ns, r.id, r.name) for r in recs
                  if r.start_ns <= mid < r.end_ns]
        if b > a and inside and min(inside)[2] == name:
            total += b - a
    return total * 1e-6 / units
