"""Milliseconds the device sits idle while the program samples (trace gaps whose middle lies in a ``sample`` span, the innermost of the program's there) per step (``train.step`` span) of the traced work."""

from _program import idle_ms


def read(run):
    return idle_ms(run, "sample", "train.step")
