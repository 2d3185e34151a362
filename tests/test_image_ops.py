"""Grayscale / flToCh / x-derivative ops vs the oracle (and vs raw f64)."""

import dataclasses

import numpy as np
import jax.numpy as jnp

from stereo_matching import ops
from stereo_matching import reference as R
from stereo_matching.config import DEFAULT_CONFIG as CFG

# exact grayscale (correction table on) — the default fast path skips
# the two table gathers and may be +1 on ~24 ppm of inputs
EXACT = dataclasses.replace(CFG, exact_integral=True)


def test_grayscale_random_exact(rng):
    rgb = rng.integers(0, 256, size=(128, 200, 3), dtype=np.uint8)
    want = R.rgb_to_grayscale(rgb, CFG)
    got = np.asarray(ops.rgb_to_grayscale(jnp.asarray(rgb), EXACT))
    np.testing.assert_array_equal(got, want)


def test_grayscale_fast_path_at_most_plus_one(rng):
    """The gather-free fast path may exceed the reference by exactly +1
    on exact-integer-rational inputs, never more, never less."""
    rgb = rng.integers(0, 256, size=(64, 100, 3), dtype=np.uint8)
    want = R.rgb_to_grayscale(rgb, CFG).astype(np.int32)
    got = np.asarray(ops.rgb_to_grayscale(jnp.asarray(rgb), CFG)).astype(np.int32)
    d = got - want
    assert set(np.unique(d)).issubset({0, 1})


def test_grayscale_known_hard_cases():
    """Combos where f64 truncation differs from naive f32 — the integer
    path with the correction table must get every one right."""
    hard = np.array(
        [[0, 87, 110], [0, 170, 100], [2, 80, 20], [3, 39, 100],
         [4, 77, 50], [4, 160, 40], [6, 74, 80], [255, 255, 255],
         [0, 0, 0], [1, 0, 0], [0, 0, 255]],
        dtype=np.uint8,
    ).reshape(1, -1, 3)
    want = R.rgb_to_grayscale(hard, CFG)
    got = np.asarray(ops.rgb_to_grayscale(jnp.asarray(hard), EXACT))
    np.testing.assert_array_equal(got, want)


def test_grayscale_exact_integer_combos():
    """All (r,g,b) with 2990r+5870g+721b ≡ 0 (mod 10000): the only
    inputs where the correction table can fire."""
    combos = []
    inv299 = pow(299, -1, 1000)
    for g in range(256):
        for b in range(256):
            c = (-(5870 * g + 721 * b)) % 10000
            if c % 10 == 0:
                r = (inv299 * (c // 10)) % 1000
                if r < 256:
                    combos.append((r, g, b))
    rgb = np.array(combos, dtype=np.uint8).reshape(1, -1, 3)
    want = R.rgb_to_grayscale(rgb, CFG)
    got = np.asarray(ops.rgb_to_grayscale(jnp.asarray(rgb), EXACT))
    np.testing.assert_array_equal(got, want)


def test_grayscale_rgba_ignores_alpha(rng):
    rgba = rng.integers(0, 256, size=(16, 16, 4), dtype=np.uint8)
    want = R.rgb_to_grayscale(rgba, CFG)
    got = np.asarray(ops.rgb_to_grayscale(jnp.asarray(rgba), EXACT))
    np.testing.assert_array_equal(got, want)


def test_fl_to_ch_matches_c_cast_semantics():
    x = np.array(
        [[0.0, 0.4, 0.6, 1.0, 254.9, 255.0, 255.5, 256.0, 300.0, 1e6,
          -0.4, -0.6, -1.0, -2.5, -255.0, -256.0, -300.0]],
        dtype=np.float32,
    )
    want = R._fl_to_ch(x)
    got = np.asarray(ops.fl_to_ch(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)


def test_x_derivative_exact(rng):
    g = rng.integers(0, 256, size=(33, 77), dtype=np.uint8)
    want = R.x_derivative(g)
    got = np.asarray(ops.x_derivative(jnp.asarray(g)))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32


def test_x_derivative_batched(rng):
    g = rng.integers(0, 256, size=(3, 17, 31), dtype=np.uint8)
    got = np.asarray(ops.x_derivative(jnp.asarray(g)))
    for i in range(3):
        np.testing.assert_array_equal(got[i], R.x_derivative(g[i]))


def test_config_validation():
    import dataclasses

    import pytest as _pytest

    from stereo_matching.config import StereoConfig

    with _pytest.raises(ValueError):
        StereoConfig(d_min=0, d_max=-1)
    with _pytest.raises(ValueError):
        StereoConfig(radius=0)
    with _pytest.raises(ValueError):
        StereoConfig(eps=0.0)
    with _pytest.raises(ValueError):
        StereoConfig(d_chunk=3)  # 16 % 3 != 0
    assert StereoConfig(d_chunk=4).size_d == 16
