"""The yardstick's arithmetic: the H100's published peaks, the local
correlation's least time (``corr_bound``, copied from ``chip_smoke.py``) and
its products, and the FLOPs a model needs, counted on the benchmark's own
plain reference under ``FlopCounterMode`` on the ``meta`` device.

Nothing here reads what the program dispatches: a count comes from shapes
and from the reference, so a later kernel cannot escape it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12                          # H100 SXM (NVIDIA data sheet)
PEAK_FLOPS = {"bf16 tensor cores": 989e12,         # dense (NVIDIA data sheet)
              "tf32 tensor cores": 494.7e12}       # dense
UNIT_OF_DTYPE = {"bfloat16": "bf16 tensor cores", "float32": "tf32 tensor cores"}


def _valid(n: int, r: int) -> int:
    """Σ over the n positions of one axis of the shifts that land inside."""
    return sum(min(i + r, n - 1) - max(i - r, 0) + 1 for i in range(n))


def corr_products(shape, r: int, backward: bool = False) -> float:
    """FLOPs of the local correlation's products on (B, H, W, C) inputs:
    2·C for each in-image shift of each position, twice as many for the two
    gradients of the backward."""
    B, H, W, C = shape
    return (2 if backward else 1) * 2.0 * B * C * _valid(H, r) * _valid(W, r)


def corr_bound(shape, r: int, dtype_name: str, backward: bool = False) -> float:
    """Least seconds for the local correlation (or its backward) on these
    inputs: each input read once and each output written once over the HBM
    rate, or the products over the fastest unit that keeps the dtype's
    accuracy (bf16 tensor cores for bf16; three TF32 passes for f32),
    whichever is longer. One number per function, shape and dtype, whatever
    implements it."""
    B, H, W, C = shape
    itemsize = 2 if dtype_name == "bfloat16" else 4
    passes = 1 if dtype_name == "bfloat16" else 3
    d = 2 * r + 1
    n_fm = 4 if backward else 2          # fm1, fm2 (and g's partners dfm1, dfm2)
    nbytes = (n_fm * B * H * W * C + B * H * W * d * d) * itemsize
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = passes * corr_products(shape, r, backward) / PEAK_FLOPS[UNIT_OF_DTYPE[dtype_name]]
    return max(t_bytes, t_ops)


def counted_flops(fn, *args, **kwargs) -> float:
    """FLOPs of ``fn(*args, **kwargs)`` as ``torch.utils.flop_counter``
    counts them (convolutions, matrix products, and their backward where
    ``fn`` runs one). Give it ``meta`` tensors: nothing is computed."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())
