"""The benchmark's own operation and byte counts, against shapes worked
by hand."""
import pytest
import torch

from benchmark import roofline

f32, bf16, f64 = torch.float32, torch.bfloat16, torch.float64


def test_block_matvec_serving_launch():
    # A: 2 * 64 * 384^2 * 4 B, x and y: 256 * 64 * 384 * 4 B each, coef 256 * 2 * 4 B
    ops, nbytes = roofline.counts("block_matvec", 2, 64, 384, 256, f32, f32)
    assert nbytes == 75_497_472 + 2 * 25_165_824 + 2_048
    assert ops == 2 * 2 * 64 * 384 * 384 * 256
    assert roofline.bound_s("block_matvec", 2, 64, 384, 256, f32, f32) == \
        pytest.approx(nbytes / 3.35e12)                          # bytes-bound: 0.0376 ms
    assert 1e3 * nbytes / 3.35e12 == pytest.approx(0.0376, abs=1e-4)


def test_precond_dot_serving_launch():
    # F bf16: 64 * 384^2 * 2 B; r and z f32; rz 256 * 64 * 4 B
    ops, nbytes = roofline.counts("precond_dot", 1, 64, 384, 256, bf16, f32)
    assert nbytes == 18_874_368 + 2 * 25_165_824 + 65_536
    assert ops == 2 * 64 * 384 * 384 * 256 + 2 * 64 * 384 * 256
    assert 1e3 * roofline.bound_s("precond_dot", 1, 64, 384, 256, bf16, f32) == \
        pytest.approx(0.0207, abs=1e-4)


def test_compute_bound_f64_shape_uses_the_f64_tensor_peak():
    # one lane-heavy f64 launch: 2 * 64 * 512^2 * 2048 ops at 67 TFLOP/s
    ops, nbytes = roofline.counts("block_matvec", 1, 64, 512, 2048, f64, f64)
    assert ops / 67e12 > nbytes / 3.35e12
    assert roofline.bound_s("block_matvec", 1, 64, 512, 2048, f64, f64) == \
        pytest.approx(ops / 67e12)


def test_share_is_mean_bound_over_mean_time_and_ignores_the_route():
    sig = (2, 64, 384, 256, f32, f32)
    b = roofline.bound_s("block_matvec", *sig)
    # 10 launches counted, 9 kernel records in the trace at twice the bound
    assert roofline.share_pct("block_matvec", {sig: 10}, 9, 9 * 2 * b) == pytest.approx(50.0)
    assert roofline.share_pct("block_matvec", {}, 9, 1.0) is None
    assert roofline.share_pct("block_matvec", {sig: 3}, 0, 0.0) is None
