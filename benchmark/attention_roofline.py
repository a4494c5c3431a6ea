"""The least time of SAM's attention with the decomposed relative-position
bias, from shapes alone (``roofline.py``'s peaks): the calls an encoder
pass needs, their operations and bytes, and the bound, whatever
implements them.
"""

from __future__ import annotations

from typing import List, Tuple

from roofline import HBM_BYTES_PER_S, PEAK_FLOPS, UNIT_OF_DTYPE

Call = Tuple[int, int, int, int]   # (batch, heads, side, head_dim): a side² map a batch row


def calls(slices: int, widths: dict) -> List[Call]:
    """The attention calls of the encoder on ``slices`` images, one a block:
    a global block attends each slice's grid² tokens, a windowed one each
    window² window of the grid padded to whole windows."""
    grid = widths["img_size"] // widths["patch_size"]
    heads, win = widths["num_heads"], widths["window_size"]
    head_dim = widths["embed_dim"] // heads
    windows = (-(-grid // win)) ** 2
    return [(slices, heads, grid, head_dim) if i in widths["global_attn_indexes"]
            else (slices * windows, heads, win, head_dim) for i in range(widths["depth"])]


def flops(call: Call) -> float:
    """q·kᵀ and the probabilities · v (2·L²·d each), and the two bias
    products, q against a side × d table for each of its side rows and
    columns (2·L·side·d each), for L = side² tokens."""
    B, n, side, d = call
    L = side * side
    return B * n * (2 * 2.0 * L * L * d + 2 * 2.0 * L * side * d)


def bound(call: Call, dtype_name: str = "bfloat16") -> float:
    """Least seconds: the products over the dtype's tensor-core peak, or q,
    k, v and the output each read or written once over the HBM rate,
    whichever is longer."""
    B, n, side, d = call
    itemsize = 2 if dtype_name == "bfloat16" else 4
    t_bytes = 4 * B * n * side * side * d * itemsize / HBM_BYTES_PER_S
    return max(flops(call) / PEAK_FLOPS[UNIT_OF_DTYPE[dtype_name]], t_bytes)
