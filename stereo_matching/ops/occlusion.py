"""Left-right consistency check and occlusion filling.

Reference: detect_occlusionOnGPU (occlusion.cu:3-15) and
fill_occlusionOnGPU1 (occlusion.cu:134-176).

The reference's fill kernel reads and writes the same buffer
concurrently — a data race (SURVEY.md §2.5.9).  This framework defines
the deterministic semantics both implementations compute in the
race-free case: every occluded pixel receives
``max(nearest valid value to its left, nearest valid value to its
right)`` taken from the ORIGINAL map, with ``v_min`` substituted when a
side has no valid pixel.  Implemented as two associative "last valid
value" scans (log-depth, no gathers, no serial row loops).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import StereoConfig, DEFAULT_CONFIG
from .shifts import shift_cols


def detect_occlusion(
    disp_left: jax.Array,
    disp_right: jax.Array,
    d_occlusion: int,
    cfg: StereoConfig = DEFAULT_CONFIG,
    dmin: int | None = None,
) -> jax.Array:
    """Write ``d_occlusion`` into LR-inconsistent left-map pixels.

    d = (int)dispL[x] (trunc cast); occluded iff x+d ∉ [0,w) or
    |d + dispR[x+d]| > D_LR (occlusion.cu:8-12).  The short-circuit
    ``||`` means dispR is only ever read in range — replicated by
    clipping the gather index and OR-ing the masks.

    PRECONDITION: ``disp_left``'s values must come from the label set
    ``cfg.disparities(dmin)`` (the WTA guarantees this for pipeline
    maps) — the gather is a select over those statically-shifted
    copies of ``disp_right``, so any other value falls through to
    dprime=0.
    Maps with a different label base pass ``dmin`` (review r5).
    """
    w = disp_left.shape[-1]
    d = disp_left.astype(jnp.int32)  # trunc toward zero
    x = jnp.arange(w, dtype=jnp.int32)
    xs = x[None, :] + d
    in_range = (xs >= 0) & (xs < w)
    # dispR[x + d]: d takes only the size_d labels the WTA can emit, so
    # the gather becomes a select over size_d statically-shifted copies
    # of dispR (static shifts fuse into one elementwise pass).
    labels = cfg.disparities(dmin)
    dprime = jnp.zeros_like(disp_right)
    for lab in labels:
        dprime = jnp.where(d == lab, shift_cols(disp_right, lab), dprime)
    bad = jnp.abs(d.astype(jnp.float32) + dprime) > jnp.float32(cfg.d_lr)
    occl = (~in_range) | bad
    return jnp.where(occl, jnp.float32(d_occlusion), disp_left)


def _last_valid_scan(vals: jax.Array, valid: jax.Array, reverse: bool):
    """Per row: value of the nearest valid pixel at <= x (or >= x when
    reversed); returns (value, found) arrays.  Generic tuple-carry
    associative scan — works for ANY float values (log-depth scan with
    a 2-tuple carry)."""
    def combine(a, b):
        av, af = a
        bv, bf = b
        return jnp.where(bf, bv, av), af | bf

    return jax.lax.associative_scan(
        combine, (vals, valid), axis=vals.ndim - 1, reverse=reverse
    )


def _last_valid_packed(disp: jax.Array, valid: jax.Array,
                       d_min: int, n_labels: int, reverse: bool):
    """Same (value, found) contract as _last_valid_scan, with a single
    int32 cummax instead of a tuple-carry scan, for maps whose valid
    values are INTEGER LABELS in
    [d_min, d_min + n_labels) — true for every pipeline disparity map
    (WTA emits labels, the fill only copies them).  Packs
    (position, label-code) into one int32 so nearest-valid becomes a
    single cummax: position dominates the key, so the max over a prefix
    is the latest valid pixel, carrying its label in the low bits."""
    w = disp.shape[-1]
    x = jnp.arange(w, dtype=jnp.int32)
    code = disp.astype(jnp.int32) - d_min  # exact: labels are small ints
    pos = (w - 1 - x) if reverse else x
    # clamp: a value outside the label set would otherwise spill into
    # a NEIGHBOR pixel's key range and corrupt the cummax (review r5;
    # in-set labels are unaffected — the fill stays exact for them)
    code = jnp.clip(code, 0, n_labels - 1)
    key = jnp.where(valid, pos * n_labels + code, jnp.int32(-1))
    m = jax.lax.cummax(key, axis=disp.ndim - 1, reverse=reverse)
    found = m >= 0
    val = ((jnp.maximum(m, 0) % n_labels) + d_min).astype(jnp.float32)
    return val, found


def fill_occlusion(
    disp: jax.Array, v_min: float, cfg: StereoConfig = DEFAULT_CONFIG,
    exact_labels: bool = True,
) -> jax.Array:
    """Fill occluded pixels (trunc(disp) < v_min, occlusion.cu:140-142)
    with max(nearest-valid-left, nearest-valid-right); a side with no
    valid pixel contributes v_min (occlusion.cu:147,161).

    ``exact_labels=True`` (default) uses the packed-cummax scan — valid
    values must be integer labels in [cfg.d_min, cfg.d_max], which the
    WTA guarantees; the fill only selects existing values so the result
    is bit-exact either way.  Pass False for maps with arbitrary float
    disparities (e.g. subpixel maps from another matcher)."""
    vminf = jnp.float32(v_min)
    occl = disp.astype(jnp.int32) < v_min
    valid = disp >= vminf  # float compare, occlusion.cu:152,167
    if exact_labels:
        lv, lf = _last_valid_packed(disp, valid, cfg.d_min, cfg.size_d, False)
        rv, rf = _last_valid_packed(disp, valid, cfg.d_min, cfg.size_d, True)
    else:
        vals = jnp.where(valid, disp, jnp.float32(0))
        lv, lf = _last_valid_scan(vals, valid, reverse=False)
        rv, rf = _last_valid_scan(vals, valid, reverse=True)
    dleft = jnp.where(lf, lv, vminf)
    dright = jnp.where(rf, rv, vminf)
    return jnp.where(occl, jnp.maximum(dleft, dright), disp)
