"""The MSM yardstick depends on the point count and scalar width only."""

import inspect

from benchlib import roofline


def test_work_depends_on_size_and_width_only():
    for fn in (roofline.msm_bytes, roofline.msm_imads, roofline.msm_least_s):
        assert list(inspect.signature(fn).parameters) == ["n", "bits"]
    assert roofline.msm_imads(1 << 20, 254) == roofline.msm_imads(1 << 20, 254)
    assert roofline.msm_imads(1 << 20, 254) > roofline.msm_imads(1 << 19, 254)
    assert roofline.msm_imads(1 << 20, 254) > roofline.msm_imads(1 << 20, 128)
    assert roofline.msm_bytes(1 << 20, 254) == (1 << 20) * 96


def test_2e20_is_compute_bound_near_three_ms():
    n, b = 1 << 20, 254
    compute = roofline.msm_imads(n, b) / roofline.PEAK_IMAD_S
    memory = roofline.msm_bytes(n, b) / roofline.PEAK_BYTES_S
    assert roofline.msm_least_s(n, b) == compute > 50 * memory
    assert 2.5e-3 < compute < 3.2e-3
    # window 16: 16 windows of 2^20 mixed adds and 2^16 full adds
    assert roofline.msm_imads(n, b) == 16 * (n * 10 + (1 << 16) * 14) * 264
