"""Host milliseconds of the whole-volume eval's Dice on the host (the program's ``lgca.dice`` span) per volume of the traced work's pass without the profiler."""

from _program import host_ms


def read(run):
    return host_ms(run, "lgca.dice", "lgca.volume", "evaluate")
