"""Device milliseconds of the registration prior (the program's ``registration`` span) per training step (``train.step`` span) of the traced work, from the span's CUDA events."""

from _program import device_ms


def read(run):
    return device_ms(run, "registration", "train.step")
