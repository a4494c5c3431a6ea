"""Host milliseconds a training batch takes to assemble (sample and collate, or the LGCA sample and its upload), per step of the traced work, from its pass without the profiler."""

from _common import span_ms


def read(run):
    return span_ms(run, "batch")
