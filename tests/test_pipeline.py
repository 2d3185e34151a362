"""End-to-end pipeline: bit-exact vs the oracle (and reference goldens)
in exact mode; near-exact (bounded mismatch count) in fast mode."""

import dataclasses
import os

import numpy as np
import pytest

from stereo_matching import reference as R
from stereo_matching.config import DEFAULT_CONFIG as CFG
from stereo_matching.pipeline import compute_disparity
from stereo_matching.utils.png import read_png

from conftest import REFERENCE_DATA, requires_reference

EXACT = dataclasses.replace(CFG, exact_integral=True)


@pytest.fixture(scope="module")
def oracle_tsukuba(tsukuba):
    left, right = tsukuba
    return R.run_pipeline(left, right, CFG)


def test_pipeline_exact_mode_bit_exact(tsukuba, oracle_tsukuba):
    left, right = tsukuba
    out = compute_disparity(left, right, EXACT, full_outputs=True)
    for key in [
        "gray_left", "gray_right", "mean_left", "mean_right",
        "best_cost_left", "best_cost_right",
        "disparity_left", "disparity_right",
        "occlusion", "occlusion_filled",
    ]:
        np.testing.assert_array_equal(out[key], oracle_tsukuba[key], err_msg=key)
    np.testing.assert_array_equal(out["cost_left_s0"], oracle_tsukuba["cost_left"][0])
    np.testing.assert_array_equal(out["cost_right_s0"], oracle_tsukuba["cost_right"][0])


@requires_reference
def test_pipeline_exact_mode_matches_committed_goldens(tsukuba):
    """Straight to the reference repo's committed PNGs (normalized the
    same way main.cu:13-35 does)."""
    left, right = tsukuba
    out = compute_disparity(left, right, EXACT, full_outputs=True)
    for key, png, normalize in [
        ("disparity_left", "disparity_mapl.png", True),
        ("disparity_right", "disparity_mapr.png", True),
        ("occlusion_filled", "occlu_mapl_filled.png", True),
        ("mean_left", "image_mean_left.png", False),
        ("gray_left", "image_left.png", False),
    ]:
        gold = read_png(os.path.join(REFERENCE_DATA, png))
        if gold.ndim == 3:
            gold = gold[..., 0]
        arr = out[key]
        if normalize:
            arr = R.write_mat_normalize(arr)
        np.testing.assert_array_equal(arr, gold, err_msg=key)


def test_pipeline_fast_mode_near_parity(tsukuba, oracle_tsukuba):
    """Fast mode (XLA-reassociated cumsums): the disparity map may
    differ from the oracle only at exact-tie pixels — bound the count."""
    left, right = tsukuba
    out = compute_disparity(left, right, CFG)
    n = out["disparity_left"].size
    for key in ["disparity_left", "disparity_right", "occlusion_filled"]:
        mism = int((out[key] != oracle_tsukuba[key]).sum())
        assert mism <= n * 2e-4, f"{key}: {mism}/{n} mismatches"


def test_pipeline_small_random_exact(small_pair):
    left, right = small_pair
    oracle = R.run_pipeline(left, right, CFG)
    out = compute_disparity(left, right, EXACT, full_outputs=True)
    for key in ["disparity_left", "disparity_right", "occlusion", "occlusion_filled",
                "best_cost_left", "mean_left"]:
        np.testing.assert_array_equal(out[key], oracle[key], err_msg=key)


def test_pipeline_batch_matches_single(small_pair):
    import jax.numpy as jnp
    from stereo_matching.pipeline import stereo_pipeline_batch

    left, right = small_pair
    batch_l = np.stack([left, left[:, ::-1]])
    batch_r = np.stack([right, right[:, ::-1]])
    out = stereo_pipeline_batch(jnp.asarray(batch_l), jnp.asarray(batch_r), EXACT)
    single0 = compute_disparity(batch_l[0], batch_r[0], EXACT)
    single1 = compute_disparity(batch_l[1], batch_r[1], EXACT)
    for k in ["disparity_left", "occlusion_filled"]:
        np.testing.assert_array_equal(np.asarray(out[k][0]), single0[k], err_msg=k)
        np.testing.assert_array_equal(np.asarray(out[k][1]), single1[k], err_msg=k)


def test_compute_disparity_stacked_matches(small_pair):
    """The single-transfer stacked fetch must equal per-key fetches,
    with AND without the int16 compact cast (exact for the
    disparity-map family)."""
    from stereo_matching.pipeline import compute_disparity_stacked

    left, right = small_pair
    a = compute_disparity_stacked(left, right, CFG)
    c = compute_disparity_stacked(left, right, CFG, compact=True)
    b = compute_disparity(left, right, CFG,
                          keys=("occlusion_filled", "occlusion"))
    for k in ("occlusion_filled", "occlusion"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_array_equal(c[k], b[k], err_msg=f"compact {k}")
        assert c[k].dtype == np.float32
    with pytest.raises(ValueError, match="unknown output keys"):
        compute_disparity_stacked(left, right, CFG, keys=("nope",))
