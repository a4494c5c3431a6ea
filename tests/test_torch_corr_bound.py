"""The kernel table's yardstick, ``chip_smoke.corr_bound``, on the CPU.

One bound per function, shape and dtype, whatever implements it: bf16 work
on bf16 tensor cores, f32 work as three TF32 tensor-core passes (the f32-
accurate tensor-core route), each against the bytes the function must move.
``chip_smoke``'s top level imports the standard library only.
"""

import inspect
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

EVAL = (26, 64, 64, 256)    # the first eval episode's query slices
TRAIN = (48, 64, 64, 256)   # E·k slices of a training step
SWEEP = (32, 64, 64, 256)   # bench_tools/corr_sweep.py's shape (rows 8 and 9)


@pytest.mark.parametrize("shape,dtype,backward,ms", [
    (EVAL, "bfloat16", False, 0.040246),   # rows 1, 2, 3, 5, 6 on the eval path
    (TRAIN, "float32", False, 0.148600),   # rows 3, 4, 5, 6 on the training path
    (TRAIN, "float32", True, 0.268795),    # row 7
    (SWEEP, "float32", False, 0.099067),   # rows 8, 9 fed f32 by the sweep
    (SWEEP, "bfloat16", False, 0.049533),  # rows 8, 9 fed bf16 by the sweep
])
def test_bound_values(shape, dtype, backward, ms):
    got, by, unit = chip_smoke.corr_bound(shape, 5, dtype, backward=backward)
    assert by == "bytes"
    assert unit == ("bf16 tensor cores" if dtype == "bfloat16" else "tf32 tensor cores")
    assert got == pytest.approx(ms, rel=1e-5)


def test_f32_tensor_work_is_three_tf32_passes():
    """The operations time of f32 is 3 × the products over the TF32 peak:
    at the training shape 11.16 GFLOP × 3 / 494.7 TFLOP/s = 0.0677 ms, below
    the bytes, so the bytes bound it; half the TF32 rate would not."""
    B, H, W, C = TRAIN
    valid = sum(min(i + 5, H - 1) - max(i - 5, 0) + 1 for i in range(H))
    ops_ms = 3 * 2.0 * B * C * valid * valid / chip_smoke.PEAK_FLOPS["tf32 tensor cores"] * 1e3
    assert ops_ms == pytest.approx(0.0677, rel=1e-2)
    assert chip_smoke.corr_bound(TRAIN, 5, "float32")[0] > ops_ms


def test_one_bound_for_every_route():
    """The bound names no implementation: the select route's check
    (check_local_corr) and the opt-in routes' check (check_variant) ask for
    it with the same arguments, so band, pack, csub and select carry one
    number at one shape and dtype."""
    params = list(inspect.signature(chip_smoke.corr_bound).parameters)
    assert params == ["shape", "r", "dtype_name", "backward"]
    for fn in (chip_smoke.check_local_corr, chip_smoke.check_variant):
        src = inspect.getsource(fn)
        assert "corr_bound(shape, r, name)" in src, fn.__name__
    assert "f32 FMA" not in chip_smoke.PEAK_FLOPS
