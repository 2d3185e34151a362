"""Model-family interface: guided (flagship) and box aggregation."""

import dataclasses

import numpy as np
import pytest

from stereo_matching.config import DEFAULT_CONFIG as CFG
from stereo_matching import reference as R
from stereo_matching.models import BoxStereoMatcher, GuidedStereoMatcher

EXACT = dataclasses.replace(CFG, exact_integral=True)


def _box_oracle(left, right, cfg):
    """NumPy oracle for the box-aggregation family: q = box_mean(cost),
    same WTA / LR / fill as the guided oracle."""
    gl = R.rgb_to_grayscale(left, cfg)
    gr = R.rgb_to_grayscale(right, cfg)

    def view(g1, g2, dmin):
        cost = R.cost_volume(g1, g2, dmin, cfg)
        best = np.full(g1.shape, R.BEST_COST_INIT, dtype=np.float32)
        dmap = np.zeros(g1.shape, dtype=np.float32)
        for s in range(cost.shape[0]):
            q = R.box_mean(cost[s], cfg.radius)
            upd = best >= q
            dmap[upd] = np.float32(dmin + s)
            best[upd] = q[upd]
        return best, dmap

    _, dl = view(gl, gr, cfg.d_min)
    _, dr = view(gr, gl, cfg.d_min_right)
    occ = R.detect_occlusion(dl, dr, cfg.d_occlusion, cfg)
    return dl, dr, occ, R.fill_occlusion(occ, cfg.v_min)


def test_box_matcher_matches_its_oracle(small_pair):
    left, right = small_pair
    dl, dr, occ, filled = _box_oracle(left, right, CFG)
    out = BoxStereoMatcher(EXACT).compute(left, right)
    np.testing.assert_array_equal(out["disparity_left"], dl)
    np.testing.assert_array_equal(out["disparity_right"], dr)
    np.testing.assert_array_equal(out["occlusion"], occ)
    np.testing.assert_array_equal(out["occlusion_filled"], filled)


def test_guided_matcher_matches_pipeline(small_pair):
    left, right = small_pair
    oracle = R.run_pipeline(left, right, CFG)
    out = GuidedStereoMatcher(EXACT).compute(left, right)
    np.testing.assert_array_equal(out["disparity_left"], oracle["disparity_left"])
    np.testing.assert_array_equal(out["occlusion_filled"], oracle["occlusion_filled"])


def test_models_share_interface(small_pair):
    left, right = small_pair
    for cls in (GuidedStereoMatcher, BoxStereoMatcher):
        out = cls(CFG).compute(left, right)
        assert out["disparity_left"].shape == left.shape[:2]
        assert out["occlusion_filled"].dtype == np.float32


def test_box_d_chunk_streaming_matches_unchunked(small_pair):
    """cfg.d_chunk (documented: bounds peak HBM) must be honored by the
    box model too — the chunked ascending `best >= q` scan reproduces
    the unchunked WTA bit-for-bit."""
    import dataclasses

    import jax.numpy as jnp

    from stereo_matching.config import DEFAULT_CONFIG as CFG
    from stereo_matching.models.box import box_stereo_pipeline

    left, right = small_pair
    base = box_stereo_pipeline(jnp.asarray(left), jnp.asarray(right), CFG)
    cfg_c = dataclasses.replace(CFG, d_chunk=4)
    got = box_stereo_pipeline(jnp.asarray(left), jnp.asarray(right), cfg_c)
    for k in ["disparity_left", "disparity_right", "best_cost_left",
              "occlusion_filled"]:
        np.testing.assert_array_equal(
            np.asarray(base[k]), np.asarray(got[k]), err_msg=k)
