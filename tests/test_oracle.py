"""Oracle vs the reference's committed golden PNGs (data/*.png).

The reference repo commits its own outputs (main.cu:162-181) — min-max
normalized via write_mat (main.cu:13-35).  The NumPy oracle must match
every one of them bit-for-bit; everything else in this repo is then
tested against the oracle.
"""

import os

import numpy as np
import pytest

from stereo_matching import reference as R
from stereo_matching.config import DEFAULT_CONFIG as CFG
from stereo_matching.utils.png import read_png

from conftest import REFERENCE_DATA, requires_reference


@pytest.fixture(scope="module")
def oracle_out(tsukuba):
    left, right = tsukuba
    return R.run_pipeline(left, right, CFG)


GOLDENS = [
    ("gray_left", "image_left.png", False),
    ("gray_right", "image_right.png", False),
    ("mean_left", "image_mean_left.png", False),
    ("mean_right", "image_mean_right.png", False),
    ("disparity_left", "disparity_mapl.png", True),
    ("disparity_right", "disparity_mapr.png", True),
    ("best_cost_left", "best_costl.png", True),
    ("best_cost_right", "best_costr.png", True),
    ("occlusion", "occlu_mapl.png", True),
    ("occlusion_filled", "occlu_mapl_filled.png", True),
]


@requires_reference
@pytest.mark.parametrize("key,png,normalize", GOLDENS)
def test_oracle_matches_reference_golden(oracle_out, key, png, normalize):
    gold = read_png(os.path.join(REFERENCE_DATA, png))
    if gold.ndim == 3:
        gold = gold[..., 0]
    arr = oracle_out[key]
    if normalize:
        arr = R.write_mat_normalize(arr)
    np.testing.assert_array_equal(np.asarray(arr), gold)


@requires_reference
@pytest.mark.parametrize("key,png", [("cost_left", "cost_lminus15.png"), ("cost_right", "cost_rminus15.png")])
def test_oracle_cost_slice_goldens(oracle_out, key, png):
    gold = read_png(os.path.join(REFERENCE_DATA, png))
    if gold.ndim == 3:
        gold = gold[..., 0]
    arr = R.write_mat_normalize(oracle_out[key][0])
    np.testing.assert_array_equal(arr, gold)
