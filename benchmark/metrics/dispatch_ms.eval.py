"""Host milliseconds of the eval runner's ``dispatch_spec`` per episode of the traced work, from its pass without the profiler (harness clock around the call)."""

from _common import span_ms


def read(run):
    return span_ms(run, "dispatch")
