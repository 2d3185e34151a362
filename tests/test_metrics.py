"""bad-N / EPE metrics and occlusion stats."""

import numpy as np

from stereo_matching.metrics import (
    bad_pixel_rate,
    end_point_error,
    occlusion_stats,
)


def test_bad_pixel_rate_basic():
    gt = np.array([[5.0, 5.0, 5.0, 0.0]])  # last pixel: no GT
    disp = np.array([[5.0, 8.0, 6.9, 100.0]])
    # errors: 0, 3, 1.9, (ignored) → 1 of 3 valid > 2.0
    assert abs(bad_pixel_rate(disp, gt, 2.0) - 100.0 / 3) < 1e-9


def test_bad_pixel_rate_invalid_disp_counts_as_bad():
    gt = np.array([[5.0, 5.0]])
    disp = np.array([[5.0, -115.0]])
    assert bad_pixel_rate(disp, gt, 2.0, invalid_below=-15.0) == 50.0


def test_bad_pixel_rate_no_valid_gt():
    assert bad_pixel_rate(np.ones((2, 2)), np.zeros((2, 2))) == 0.0


def test_end_point_error():
    gt = np.array([[4.0, 2.0, 0.0]])
    disp = np.array([[5.0, 0.0, 7.0]])
    assert abs(end_point_error(disp, gt) - 1.5) < 1e-9


def test_occlusion_stats():
    occ = np.array([[-115.0, 0.0, -15.0, -116.0]], dtype=np.float32)
    s = occlusion_stats(occ, v_min=-15)
    assert s["occluded_pixels"] == 2
    assert s["occluded_pct"] == 50.0
