"""The flagship guided-filter matcher (the reference pipeline)."""

from __future__ import annotations

import jax.numpy as jnp

from ..pipeline import stereo_pipeline
from .base import StereoMatcher


class GuidedStereoMatcher(StereoMatcher):
    """Guided-filter cost aggregation (guidedFilter.cu semantics), exact
    parity mode via cfg.exact_integral."""

    def _forward(self, left, right) -> dict:
        return stereo_pipeline(jnp.asarray(left), jnp.asarray(right), self.cfg)
