"""Shared arithmetic of the per-layer readers. Each reader returns None
where its run holds nothing to read; none returns 0 for a share. A traced
run does its fixed work twice (``harness.traced_work``): shares of the
window divide by the plain pass's wall and host spans come from it, so the
profiler's host overhead stretches neither; device times come from the
trace."""

from __future__ import annotations

import roofline


def idle_share(run):
    t, wall = run.trace_data, run.plain_window_s
    if t is None or not wall or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / wall)


def mfu(run):
    wall = run.plain_window_s
    if not wall or not run.work_flops or run.peak_unit is None:
        return None
    return 100.0 * run.work_flops / (wall * roofline.PEAK_FLOPS[run.peak_unit])


def corr_roofline(run, dtype: str, backward: bool, match):
    """Σ of ``corr_bound`` over the correlation calls the traced work needs
    (of this dtype and direction), over the device time of the kernels
    ``match`` accepts; None where no such kernel ran."""
    t = run.trace_data
    if t is None:
        return None
    calls = [c for c in run.corr_calls if c[2] == dtype and c[3] == backward]
    seconds, n = t.seconds_of(match)
    if not calls or n == 0 or seconds <= 0:
        return None
    return 100.0 * sum(roofline.corr_bound(s, r, d, b) for s, r, d, b in calls) / seconds


def span_ms(run, name):
    vals = run.plain_spans.get(name)
    if not vals:
        return None
    return 1e3 * sum(vals) / len(vals)
