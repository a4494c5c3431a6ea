"""Host milliseconds of the program's train samplers (``sample`` spans) per step (``train.step`` span) of the traced work's pass without the profiler."""

from _program import host_ms


def read(run):
    return host_ms(run, "sample", "train.step", "batch")
