"""Share of its roofline that the f32 forward correlation (``local_corr.cu``) reaches in the traced training steps."""

from _common import corr_roofline


def read(run):
    return corr_roofline(run, "float32", False, lambda n: "local_corr" in n and "bwd" not in n)
