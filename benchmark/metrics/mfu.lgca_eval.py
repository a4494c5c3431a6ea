"""FLOPs of the traced volumes' chunk forwards over the wall of the same work run without the profiler, times the TF32 dense peak."""

from _common import mfu


def read(run):
    return mfu(run)
