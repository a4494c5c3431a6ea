"""Device milliseconds of LGCANet_V3's context net (the program's ``lgca.context`` spans, one a chunk) per volume (``lgca.volume`` span) of the traced work, from the spans' CUDA events."""

from _program import device_ms


def read(run):
    return device_ms(run, "lgca.context", "lgca.volume")
