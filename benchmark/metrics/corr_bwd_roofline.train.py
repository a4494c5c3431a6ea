"""Share of its roofline that the correlation's backward (``local_corr_bwd.cu``) reaches in the traced training steps."""

from _common import corr_roofline


def read(run):
    return corr_roofline(run, "float32", True, lambda n: "local_corr_bwd" in n)
