"""Cost volume and guided-filter+WTA vs the oracle."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from stereo_matching import ops
from stereo_matching import reference as R
from stereo_matching.config import DEFAULT_CONFIG as CFG
from stereo_matching.ops.guided import _recip_var_eps

EXACT = dataclasses.replace(CFG, exact_integral=True)


@pytest.fixture(scope="module")
def gray_pair(rng=None):
    rng = np.random.default_rng(7)
    h, w = 40, 56
    base = rng.integers(0, 256, size=(h, w + 20), dtype=np.uint8)
    return base[:, 10 : 10 + w], base[:, 4 : 4 + w]


def test_cost_volume_left_exact(gray_pair):
    g1, g2 = gray_pair
    want = R.cost_volume(g1, g2, CFG.d_min, CFG)
    got = np.asarray(jax.jit(
        lambda a, b: ops.cost_volume(a, b, CFG.d_min, CFG), static_argnums=()
    )(jnp.asarray(g1), jnp.asarray(g2)))
    np.testing.assert_array_equal(got, want)


def test_cost_volume_right_exact(gray_pair):
    g1, g2 = gray_pair
    want = R.cost_volume(g2, g1, CFG.d_min_right, CFG)
    got = np.asarray(ops.cost_volume(jnp.asarray(g2), jnp.asarray(g1), CFG.d_min_right, CFG))
    np.testing.assert_array_equal(got, want)


def test_cost_volume_oob_constant(gray_pair):
    """Out-of-range x+d must give exactly 2.5 (costVolume.cu:184)."""
    g1, g2 = gray_pair
    got = np.asarray(ops.cost_volume(jnp.asarray(g1), jnp.asarray(g2), CFG.d_min, CFG))
    # slice 0 has d = -15: first 15 columns out of range
    assert (got[0, :, :15] == np.float32(2.5)).all()


def test_recip_var_eps_matches_f64(rng):
    var = np.concatenate(
        [rng.uniform(0, 16300, 200_000), rng.uniform(0, 1, 100_000),
         rng.uniform(-0.5, 0.5, 50_000)]
    ).astype(np.float32)
    want = (np.float64(1.0) / (var.astype(np.float64) + np.float64(CFG.eps))).astype(np.float32)
    got = np.asarray(jax.jit(_recip_var_eps, static_argnums=1)(jnp.asarray(var), CFG.eps))
    np.testing.assert_array_equal(got, want)


def test_guided_filter_wta_exact(gray_pair):
    g1, g2 = gray_pair
    cost = R.cost_volume(g1, g2, CFG.d_min, CFG)
    want_best, want_dmap, want_mean = R.guided_filter_wta(g1, cost, CFG.d_min, CFG)
    best, dmap, mean = jax.jit(
        lambda g, c: ops.guided_filter_wta(g, c, CFG.d_min, EXACT)
    )(jnp.asarray(g1), jnp.asarray(cost))
    np.testing.assert_array_equal(np.asarray(mean), want_mean)
    np.testing.assert_array_equal(np.asarray(best), want_best)
    np.testing.assert_array_equal(np.asarray(dmap), want_dmap)


@pytest.mark.parametrize("d_chunk", [1, 4, 8])
def test_guided_filter_chunked_equals_unchunked(gray_pair, d_chunk):
    g1, g2 = gray_pair
    cost = R.cost_volume(g1, g2, CFG.d_min, CFG)
    cfg_c = dataclasses.replace(EXACT, d_chunk=d_chunk)
    b0, d0, m0 = ops.guided_filter_wta(jnp.asarray(g1), jnp.asarray(cost), CFG.d_min, EXACT)
    b1, d1, m1 = ops.guided_filter_wta(jnp.asarray(g1), jnp.asarray(cost), CFG.d_min, cfg_c)
    np.testing.assert_array_equal(np.asarray(b0), np.asarray(b1))
    np.testing.assert_array_equal(np.asarray(d0), np.asarray(d1))
    np.testing.assert_array_equal(np.asarray(m0), np.asarray(m1))


def test_wta_tie_breaking_largest_d_wins():
    """Constant cost volume ⇒ identical q for every d ⇒ the reference's
    `best >= q` streaming rule selects the LAST (largest) disparity
    (guidedFilter.cu:403-411 with ascending loop)."""
    h, w = 24, 32
    gray = np.full((h, w), 128, dtype=np.uint8)
    cost = np.full((CFG.size_d, h, w), 2.5, dtype=np.float32)
    want_best, want_dmap, _ = R.guided_filter_wta(gray, cost, CFG.d_min, CFG)
    best, dmap, _ = ops.guided_filter_wta(jnp.asarray(gray), jnp.asarray(cost), CFG.d_min, EXACT)
    assert (np.asarray(dmap) == CFG.d_max).all()  # largest d = dmin+15 = 0
    np.testing.assert_array_equal(np.asarray(dmap), want_dmap)
    np.testing.assert_array_equal(np.asarray(best), want_best)


@pytest.mark.parametrize("radius", [1, 4])
def test_guided_filter_wta_exact_other_radii(gray_pair, radius):
    cfgr = dataclasses.replace(EXACT, radius=radius)
    g1, g2 = gray_pair
    cost = R.cost_volume(g1, g2, cfgr.d_min, cfgr)
    want_best, want_dmap, want_mean = R.guided_filter_wta(g1, cost, cfgr.d_min, cfgr)
    best, dmap, mean = ops.guided_filter_wta(jnp.asarray(g1), jnp.asarray(cost), cfgr.d_min, cfgr)
    np.testing.assert_array_equal(np.asarray(mean), want_mean)
    np.testing.assert_array_equal(np.asarray(best), want_best)
    np.testing.assert_array_equal(np.asarray(dmap), want_dmap)


def test_pipeline_narrow_disparity_range_exact(gray_pair):
    """8-disparity range (d in [-7, 0]) through the oracle and the jnp
    path; exercises non-default size_d everywhere."""
    from stereo_matching.pipeline import compute_disparity

    cfg8 = dataclasses.replace(EXACT, d_min=-7, d_max=0)
    g1, g2 = gray_pair
    rgb1 = np.repeat(g1[..., None], 3, axis=-1)
    rgb2 = np.repeat(g2[..., None], 3, axis=-1)
    oracle = R.run_pipeline(rgb1, rgb2, cfg8)
    out = compute_disparity(rgb1, rgb2, cfg8)
    for key in ["disparity_left", "disparity_right", "occlusion", "occlusion_filled"]:
        np.testing.assert_array_equal(out[key], oracle[key], err_msg=key)
