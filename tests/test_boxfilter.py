"""Integral image / clamped box mean vs the oracle."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from stereo_matching.ops.boxfilter import (
    box_mean,
    integral_image,
    strict_mul,
    window_area,
)
from stereo_matching import reference as R


@pytest.mark.parametrize("shape", [(288, 384), (19, 19), (1, 50), (50, 1), (7, 130)])
def test_integral_exact_matches_numpy(rng, shape):
    x = rng.uniform(0, 255, size=shape).astype(np.float32)
    got = np.asarray(jax.jit(lambda a: integral_image(a, exact=True))(x))
    np.testing.assert_array_equal(got, R.integral_image(x))


def test_integral_fast_close(rng):
    x = rng.uniform(0, 255, size=(288, 384)).astype(np.float32)
    got = np.asarray(integral_image(jnp.asarray(x)))
    want = R.integral_image(x)
    # values reach ~5e9; XLA's reassociated cumsum differs from the
    # sequential one by O(100) ulps there
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("radius", [1, 4, 9])
@pytest.mark.parametrize("shape", [(64, 96), (20, 20), (5, 40)])
def test_box_mean_exact(rng, radius, shape):
    x = rng.uniform(-10, 255, size=shape).astype(np.float32)
    got = np.asarray(jax.jit(lambda a: box_mean(a, radius, exact=True))(x))
    np.testing.assert_array_equal(got, R.box_mean(x, radius))


def test_box_mean_radius_larger_than_image(rng):
    """Window clamping when the window covers the whole image."""
    x = rng.uniform(0, 255, size=(8, 12)).astype(np.float32)
    got = np.asarray(jax.jit(lambda a: box_mean(a, 9, exact=True))(x))
    np.testing.assert_array_equal(got, R.box_mean(x, 9))


def test_box_mean_batched_matches_per_slice(rng):
    x = rng.uniform(0, 10, size=(5, 33, 47)).astype(np.float32)
    got = np.asarray(jax.jit(lambda a: box_mean(a, 9, exact=True))(x))
    for i in range(5):
        np.testing.assert_array_equal(got[i], R.box_mean(x[i], 9))


def test_window_area_matches_reference_formula():
    h, w, r = 30, 40, 9
    area = np.asarray(window_area(h, w, r))
    y = np.arange(h)[:, None]
    x = np.arange(w)[None, :]
    want = (
        (np.minimum(w - 1, x + r) - np.maximum(-1, x - r - 1))
        * (np.minimum(h - 1, y + r) - np.maximum(-1, y - r - 1))
    ).astype(np.float32)
    np.testing.assert_array_equal(area, want)
    assert area[h // 2, w // 2] == (2 * r + 1) ** 2


def test_strict_mul_blocks_fma(rng):
    """x - strict_mul(y, y) must equal numpy's separately-rounded result
    even though XLA contracts plain x - y*y into an FMA."""
    x = rng.uniform(100, 16000, size=(1 << 16,)).astype(np.float32)
    y = rng.uniform(99, 16000, size=(1 << 16,)).astype(np.float32)
    got = np.asarray(jax.jit(lambda x, y: x - strict_mul(y, y))(x, y))
    np.testing.assert_array_equal(got, x - y * y)
