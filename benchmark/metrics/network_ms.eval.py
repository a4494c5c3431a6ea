"""Device milliseconds of the episode's network (the program's ``network`` span: the model through the refinements' masks) per episode (``dispatch`` span) of the traced work, from the span's CUDA events."""

from _program import device_ms


def read(run):
    return device_ms(run, "network", "dispatch")
