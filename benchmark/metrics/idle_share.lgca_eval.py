"""1 − the device time that the trace of the fixed LGCA eval work shows (kernels, copies, memsets) over the wall of the same work run without the profiler."""

from _common import idle_share


def read(run):
    return idle_share(run)
