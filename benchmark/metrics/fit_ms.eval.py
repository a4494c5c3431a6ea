"""Device milliseconds of the episode's registration (the program's ``registration`` span: the affine fit, the warps) per episode (``dispatch`` span) of the traced work, from the span's CUDA events."""

from _program import device_ms


def read(run):
    return device_ms(run, "registration", "dispatch")
