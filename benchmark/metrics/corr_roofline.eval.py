"""Share of its roofline that the bf16 forward correlation (``local_corr.cu``) reaches: the bound of the calls the traced episodes need over its kernels' device time."""

from _common import corr_roofline


def read(run):
    return corr_roofline(run, "bfloat16", False, lambda n: "local_corr" in n and "bwd" not in n)
