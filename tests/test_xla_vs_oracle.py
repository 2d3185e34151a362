"""The XLA pipeline against the NumPy oracle over frame shapes x
disparity ranges x box radii x d_chunk: exact mode bit-exact on every
map, fast mode within the near-tie bound."""

import dataclasses
import itertools
import math

import numpy as np
import pytest

from stereo_matching import reference as R
from stereo_matching.config import StereoConfig
from stereo_matching.pipeline import compute_disparity
from stereo_matching.utils.synth import make_scene

SHAPES = [(24, 40), (37, 53), (48, 96)]
RANGES = [(-15, 0), (-7, 0), (-5, 4)]
RADII = [2, 9]
CHUNKED = [False, True]   # d_chunk None, or a proper divisor of size_d

CASES = list(itertools.product(SHAPES, RANGES, RADII, CHUNKED))

# fraction of pixels fast mode may flip (WTA near-ties), as everywhere
TIE_BOUND = 2e-3

MAPS = ("disparity_left", "disparity_right", "occlusion", "occlusion_filled")


def _case(shape, rng_, radius, chunked, exact):
    h, w = shape
    d_min, d_max = rng_
    size_d = d_max - d_min + 1
    d_chunk = None
    if chunked:
        d_chunk = next(c for c in range(size_d // 2, 0, -1) if size_d % c == 0)
    cfg = StereoConfig(d_min=d_min, d_max=d_max, radius=radius,
                       d_chunk=d_chunk, exact_integral=exact)
    s = make_scene(h, w, ndisp=max(8, size_d), seed=h * 1000 + w + radius)
    return s["left"], s["right"], cfg


def _ids(case):
    (h, w), (a, b), r, c = case
    return f"{h}x{w}-d{a}:{b}-r{r}-{'chunk' if c else 'whole'}"


@pytest.mark.parametrize("shape,rng_,radius,chunked", CASES,
                         ids=[_ids(c) for c in CASES])
def test_exact_mode_bit_exact(shape, rng_, radius, chunked):
    left, right, cfg = _case(shape, rng_, radius, chunked, exact=True)
    oracle = R.run_pipeline(left, right, cfg)
    out = compute_disparity(left, right, cfg, full_outputs=True)
    for key in MAPS + ("best_cost_left", "best_cost_right", "mean_left",
                       "gray_left"):
        np.testing.assert_array_equal(out[key], oracle[key], err_msg=key)


@pytest.mark.parametrize("shape,rng_,radius,chunked", CASES,
                         ids=[_ids(c) for c in CASES])
def test_fast_mode_within_tie_bound(shape, rng_, radius, chunked):
    left, right, cfg = _case(shape, rng_, radius, chunked, exact=False)
    oracle = R.run_pipeline(left, right, cfg)
    out = compute_disparity(left, right, cfg)
    bound = math.ceil(TIE_BOUND * left.shape[0] * left.shape[1])
    for key in MAPS:
        mism = int((out[key] != oracle[key]).sum())
        assert mism <= bound, f"{key}: {mism} pixels differ (bound {bound})"


def test_chunked_fast_mode_equals_whole_volume():
    """d_chunk only bounds memory: in fast mode too the chunked scan
    picks the same labels as the whole-volume WTA."""
    left, right, cfg = _case((48, 96), (-15, 0), 9, False, exact=False)
    whole = compute_disparity(left, right, cfg)
    chunked = compute_disparity(left, right,
                                dataclasses.replace(cfg, d_chunk=4))
    for key in MAPS:
        np.testing.assert_array_equal(chunked[key], whole[key], err_msg=key)
