"""The yardstick's arithmetic on cases worked out by hand."""

import pytest
import torch
import torch.nn.functional as F

import roofline


def test_corr_products_by_hand():
    # 3 × 3 image, r = 1: per axis the in-image shifts are 2 + 3 + 2 = 7
    assert roofline.corr_products((1, 3, 3, 16), 1) == 2 * 16 * 7 * 7
    assert roofline.corr_products((2, 3, 3, 16), 1, backward=True) == 2 * 2 * 2 * 16 * 49


def test_corr_bound_by_hand():
    # bf16, 64 × 64 × 256 at r = 5: bytes-bound
    B, H, W, C, r = 26, 64, 64, 256, 5
    nbytes = (2 * B * H * W * C + B * H * W * 121) * 2
    assert roofline.corr_bound((B, H, W, C), r, "bfloat16") == pytest.approx(nbytes / 3.35e12)
    assert roofline.corr_bound((B, H, W, C), r, "bfloat16") * 1e3 == pytest.approx(0.0402, abs=1e-4)
    # f32 counts three TF32 passes of the products
    flops = 3 * roofline.corr_products((B, H, W, C), r)
    nbytes = (2 * B * H * W * C + B * H * W * 121) * 4
    assert roofline.corr_bound((B, H, W, C), r, "float32") == pytest.approx(
        max(nbytes / 3.35e12, flops / 494.7e12))


def test_counted_flops_of_a_convolution_and_its_backward():
    x = torch.empty(2, 8, 16, 16, device="meta", requires_grad=True)
    w = torch.empty(4, 8, 3, 3, device="meta", requires_grad=True)
    fwd = 2 * 2 * 4 * 16 * 16 * 8 * 9
    assert roofline.counted_flops(F.conv2d, x, w, padding=1) == fwd
    assert roofline.counted_flops(lambda: F.conv2d(x, w, padding=1).sum().backward()) == 3 * fwd
