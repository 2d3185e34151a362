"""Sanitizer-style runs (SURVEY.md §5: the reference has none; we run
the pipeline under jax_debug_nans and checkify to prove the graph is
NaN/Inf-free and in-bounds)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from stereo_matching.config import DEFAULT_CONFIG as CFG
from stereo_matching.pipeline import stereo_pipeline


def test_pipeline_no_nans(small_pair):
    left, right = small_pair
    with jax.debug_nans(True):
        out = stereo_pipeline(jnp.asarray(left), jnp.asarray(right), CFG)
        jax.block_until_ready(out)
    for v in out.values():
        assert np.isfinite(np.asarray(v)).all()


def test_pipeline_checkify_clean(small_pair):
    from jax.experimental import checkify

    left, right = small_pair
    f = checkify.checkify(
        lambda l, r: stereo_pipeline(l, r, CFG)["occlusion_filled"],
        errors=checkify.float_checks | checkify.index_checks,
    )
    err, out = jax.jit(f)(jnp.asarray(left), jnp.asarray(right))
    # throws if any NaN/Inf/OOB-index error was recorded
    checkify.check_error(err)
    assert np.isfinite(np.asarray(out)).all()
