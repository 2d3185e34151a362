"""Plain box-mean cost aggregation (classic SAD+box baseline).

The reference sketches this family in dead code (winner_take_all.cuh's
commented mean_x/mean_y separable box, filter.cu's standalone box
filter — SURVEY.md §2.4); BASELINE.json config #1 names it explicitly.
Aggregation is q = box_mean(cost slice); everything around it (cost
volume, the ascending `best >= q` WTA, LR check, occlusion fill) is
shared with the guided model.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .. import ops
from ..config import StereoConfig, DEFAULT_CONFIG
from ..ops.boxfilter import box_mean, window_area
from ..ops.guided import BEST_COST_INIT
from .base import StereoMatcher


@functools.partial(jax.jit, static_argnames=("cfg",))
def box_stereo_pipeline(rgb_left, rgb_right, cfg: StereoConfig = DEFAULT_CONFIG) -> dict:
    gl = ops.rgb_to_grayscale(rgb_left, cfg)
    gr = ops.rgb_to_grayscale(rgb_right, cfg)
    h, w = gl.shape
    area = window_area(h, w, cfg.radius)

    def view(g1, g2, dmin):
        cost = ops.cost_volume(g1, g2, dmin, cfg)
        size_d = cost.shape[0]
        dc = cfg.d_chunk or size_d   # divides size_d (config validation)
        if dc == size_d:
            q = box_mean(cost, cfg.radius, area, exact=cfg.exact_integral)
            best, sidx = ops.streaming_wta(q)
            return best, (dmin + sidx).astype(jnp.float32)

        # d-chunk streaming through THE shared ascending `best >= q`
        # carry (ops/guided.py::chunked_wta_scan — one home for the
        # cross-chunk tie rule)
        from ..ops.guided import chunked_wta_scan

        return chunked_wta_scan(
            cost, dc, dmin,
            lambda chunk: box_mean(chunk, cfg.radius, area,
                                   exact=cfg.exact_integral))

    best_l, dmap_l = view(gl, gr, cfg.d_min)
    best_r, dmap_r = view(gr, gl, cfg.d_min_right)
    # the post stage (LR check + fill) shared with the guided pipeline
    from ..pipeline import _post

    occ, filled = _post(dmap_l, dmap_r, cfg)
    return {
        "disparity_left": dmap_l,
        "disparity_right": dmap_r,
        "best_cost_left": best_l,
        "best_cost_right": best_r,
        "occlusion": occ,
        "occlusion_filled": filled,
    }


class BoxStereoMatcher(StereoMatcher):
    """Box-mean aggregation: cheaper and softer than the guided filter
    (no edge-preserving coefficients)."""

    def _forward(self, left, right) -> dict:
        return box_stereo_pipeline(jnp.asarray(left), jnp.asarray(right), self.cfg)
