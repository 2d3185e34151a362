"""LR consistency check and occlusion fill vs the oracle."""

import numpy as np
import jax
import jax.numpy as jnp

from stereo_matching import ops
from stereo_matching import reference as R
from stereo_matching.config import DEFAULT_CONFIG as CFG


def _random_disp(rng, h, w, lo, hi):
    return rng.integers(lo, hi + 1, size=(h, w)).astype(np.float32)


def test_detect_occlusion_exact(rng):
    h, w = 37, 61
    dl = _random_disp(rng, h, w, CFG.d_min, CFG.d_max)
    dr = _random_disp(rng, h, w, -CFG.d_max, -CFG.d_min)
    want = R.detect_occlusion(dl, dr, CFG.d_occlusion, CFG)
    got = np.asarray(jax.jit(
        lambda a, b: ops.detect_occlusion(a, b, CFG.d_occlusion, CFG)
    )(jnp.asarray(dl), jnp.asarray(dr)))
    np.testing.assert_array_equal(got, want)


def test_detect_occlusion_out_of_range_marked(rng):
    """Pixels whose x+d leaves the image are always occluded
    (occlusion.cu:8: x+d ∉ [0,w))."""
    h, w = 5, 20
    dl = np.full((h, w), -15.0, dtype=np.float32)
    dr = np.zeros((h, w), dtype=np.float32)
    got = np.asarray(ops.detect_occlusion(jnp.asarray(dl), jnp.asarray(dr), CFG.d_occlusion, CFG))
    assert (got[:, :15] == CFG.d_occlusion).all()


def test_fill_occlusion_exact(rng):
    h, w = 29, 83
    disp = _random_disp(rng, h, w, CFG.d_min, CFG.d_max)
    # punch occlusion holes (runs of the sentinel)
    mask = rng.random((h, w)) < 0.25
    disp[mask] = np.float32(CFG.d_occlusion)
    want = R.fill_occlusion(disp, CFG.v_min)
    got = np.asarray(jax.jit(lambda a: ops.fill_occlusion(a, CFG.v_min, CFG))(jnp.asarray(disp)))
    np.testing.assert_array_equal(got, want)


def test_fill_occlusion_whole_row_occluded():
    """A fully-occluded row gets v_min everywhere (both scans fail,
    occlusion.cu:147,161)."""
    disp = np.full((3, 16), float(CFG.d_occlusion), dtype=np.float32)
    got = np.asarray(ops.fill_occlusion(jnp.asarray(disp), CFG.v_min, CFG))
    want = R.fill_occlusion(disp, CFG.v_min)
    np.testing.assert_array_equal(got, want)
    assert (got == CFG.v_min).all()


def test_fill_occlusion_contiguous_run_takes_max_of_ends():
    disp = np.array([[0.0, -115.0, -115.0, -115.0, -3.0]], dtype=np.float32)
    got = np.asarray(ops.fill_occlusion(jnp.asarray(disp), CFG.v_min, CFG))
    want = R.fill_occlusion(disp, CFG.v_min)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [[0.0, 0.0, 0.0, 0.0, -3.0]])


def test_packed_fill_equals_generic_scan(rng):
    """The packed-cummax fill (single int32 cummax) must match the
    generic tuple-carry scan bit-for-bit on label maps, including
    all-occluded rows and rows with one valid side."""
    import dataclasses

    import jax.numpy as jnp

    from stereo_matching.config import DEFAULT_CONFIG as CFG
    from stereo_matching.ops.occlusion import fill_occlusion

    for d_min, d_max in [(-15, 0), (-8, 8), (-127, 0)]:
        cfg = dataclasses.replace(CFG, d_min=d_min, d_max=d_max)
        labels = np.arange(d_min, d_max + 1, dtype=np.float32)
        disp = rng.choice(labels, size=(23, 310)).astype(np.float32)
        occl = rng.random((23, 310)) < 0.3
        disp = np.where(occl, np.float32(cfg.d_occlusion), disp)
        disp[3, :] = cfg.d_occlusion          # fully occluded row
        disp[4, :150] = cfg.d_occlusion       # no valid left side
        disp[5, 100:] = cfg.d_occlusion       # no valid right side
        fast = np.asarray(fill_occlusion(jnp.asarray(disp), cfg.v_min, cfg))
        slow = np.asarray(fill_occlusion(jnp.asarray(disp), cfg.v_min, cfg,
                                         exact_labels=False))
        np.testing.assert_array_equal(fast, slow, err_msg=f"{d_min},{d_max}")


def test_detect_occlusion_custom_label_base():
    """Maps whose labels come from a non-default base (e.g. the right
    view's d_min_right labels) must pass ``dmin`` so the select tree
    enumerates the right label set (review r5) — output must equal the
    oracle's gather for those labels."""
    import numpy as np
    import jax.numpy as jnp

    from stereo_matching import reference as R
    from stereo_matching.config import DEFAULT_CONFIG as CFG
    from stereo_matching.ops.occlusion import detect_occlusion

    rng = np.random.default_rng(3)
    base = CFG.d_min_right                       # labels 0..15
    dl = rng.integers(base, base + CFG.size_d, (24, 96)).astype(np.float32)
    dr = rng.integers(CFG.d_min, CFG.d_max + 1, (24, 96)).astype(np.float32)
    got = np.asarray(detect_occlusion(
        jnp.asarray(dl), jnp.asarray(dr), CFG.d_occlusion, CFG, dmin=base))
    want = R.detect_occlusion(dl, dr, CFG.d_occlusion, CFG)
    np.testing.assert_array_equal(got, want)
