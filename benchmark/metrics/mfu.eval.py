"""FLOPs the traced episodes need (the reference's convolutions and products, the correlation's products) over the wall of the same work run without the profiler, times the bf16 dense peak."""

from _common import mfu


def read(run):
    return mfu(run)
