"""Host milliseconds of the whole-volume eval's prediction fetch (the program's ``lgca.fetch`` span: the wait for the queued chunks and the copy) per volume of the traced work's pass without the profiler."""

from _program import host_ms


def read(run):
    return host_ms(run, "lgca.fetch", "lgca.volume", "evaluate")
