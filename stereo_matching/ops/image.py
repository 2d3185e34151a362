"""Image-plane ops: grayscale conversion, float→uint8, x-derivative.

Reference kernels (all under /root/reference/stereo_matching_cuda/):
  * sumArraysOnGPU      rgb_to_grayscale.cu:14-23
  * flToChOnGPU         guidedFilter.cu:451-458
  * x_derivativeOnGPU   costVolume.cu:358-381
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import StereoConfig, DEFAULT_CONFIG


# ----------------------------------------------------------------------
# Grayscale — exact integer re-derivation of the reference's float64 math
# ----------------------------------------------------------------------
#
# The reference computes ``val = R_W*r + G_W*g + B_W*b`` in double and
# truncates to uint8 (rgb_to_grayscale.cu:9-10; weights 0.299 / 0.587 /
# 0.0721, SystemIncludes.h:7-9).  float32 cannot reproduce this (532 of
# the 256^3 inputs truncate differently), and f64 is slow or absent on
# accelerators.
#
# Exact integer route: with n = 2990*r + 5870*g + 721*b (int32), the
# *rational* value is n/10000.  The double-rounded value differs from it
# by < 1e-13, while the distance of n/10000 from an integer is either 0
# or >= 1e-4.  Hence trunc(val_f64) == n // 10000 for every input with
# n % 10000 != 0.  When n % 10000 == 0 the rational is exactly the
# integer k = n/10000 and the answer depends on the *sign* of the
# accumulated f64 rounding error (k-1 if negative).  For fixed (g, b),
# 2990*r = -5870*g - 721*b (mod 10000) has at most ONE solution r in
# [0, 256) (since gcd(299, 1000) = 1), so a (256, 256) host-precomputed
# table of (special_r, delta) makes the device computation bit-exact.


@functools.lru_cache(maxsize=8)
def _grayscale_tables(r_w: float, g_w: float, b_w: float):
    """Host-side (numpy f64) precomputation of the exact-integer-case
    correction tables.  Only valid for the default weights' decimal
    scaling; other weights fall back to (empty) tables + f32 path."""
    if (r_w, g_w, b_w) != (0.299, 0.587, 0.0721):
        return None
    g = np.arange(256)
    b = np.arange(256)
    gg, bb = np.meshgrid(g, b, indexing="ij")
    c = (-(5870 * gg + 721 * bb)) % 10000
    inv299 = pow(299, -1, 1000)  # 2990*r ≡ c (mod 10000) ⇔ 299*r ≡ c/10 (mod 1000)
    has = (c % 10) == 0
    rsol = (inv299 * (c // 10)) % 1000
    special = np.where(has & (rsol < 256), rsol, -1).astype(np.int32)
    # delta = 1 where the reference's double arithmetic lands strictly
    # below the exact integer (truncates to k-1).
    rr = np.maximum(special, 0).astype(np.float64)
    x64 = r_w * rr + g_w * gg.astype(np.float64) + b_w * bb.astype(np.float64)
    k = np.floor((2990 * np.maximum(special, 0) + 5870 * gg + 721 * bb) / 10000 + 0.5)
    delta = ((special >= 0) & (x64 < k)).astype(np.int32)
    # numpy only: jax arrays here would be cached across traces and leak
    # tracers / stale backends.
    return special, delta


def rgb_to_grayscale(rgb: jax.Array, cfg: StereoConfig = DEFAULT_CONFIG) -> jax.Array:
    """uint8 (H,W,C) → uint8 (H,W); bit-exact vs the reference f64 math
    when ``cfg.exact_integral`` is on.

    Mirrors sumArraysOnGPU (rgb_to_grayscale.cu:14-23): alpha channel
    (C=4) ignored; truncating cast.  The integer floor n//10000 is exact
    for every input except the ~1,700 (r,g,b) triples whose rational
    value is an exact integer (correction table, see module comment).
    The table lookups are TWO gathers, so the default (fast) path skips
    the correction: at most a +1 gray
    shift on ~32 ppm of inputs (536 of the 256^3 cube; 3-4 pixels per
    Tsukuba frame), inside
    the fast path's WTA-tie tolerance.  Parity mode pays for the
    gathers.
    """
    r = rgb[..., 0].astype(jnp.int32)
    g = rgb[..., 1].astype(jnp.int32)
    b = rgb[..., 2].astype(jnp.int32)
    tables = _grayscale_tables(cfg.r_w, cfg.g_w, cfg.b_w)
    if tables is None:
        val = (
            jnp.float32(cfg.r_w) * r.astype(jnp.float32)
            + jnp.float32(cfg.g_w) * g.astype(jnp.float32)
            + jnp.float32(cfg.b_w) * b.astype(jnp.float32)
        )
        return val.astype(jnp.uint8)
    n = 2990 * r + 5870 * g + 721 * b
    v = n // 10000
    if not cfg.exact_integral:
        return v.astype(jnp.uint8)
    special, delta = (jnp.asarray(t) for t in tables)
    corr = jnp.where(r == special[g, b], delta[g, b], 0)
    return (v - corr).astype(jnp.uint8)


# ----------------------------------------------------------------------
# float → uint8 (flToChOnGPU, guidedFilter.cu:451-458)
# ----------------------------------------------------------------------
def fl_to_ch(img: jax.Array) -> jax.Array:
    """float32 → uint8: C-style trunc-toward-zero int cast, clamp > 255
    to 255, then (unsigned char) wraparound for negatives."""
    c = img.astype(jnp.int32)  # XLA f32→s32 convert truncates toward zero
    c = jnp.where(c > 255, 255, c)
    return (c & 0xFF).astype(jnp.uint8)


# ----------------------------------------------------------------------
# x-derivative (x_derivativeOnGPU, costVolume.cu:358-381)
# ----------------------------------------------------------------------
def x_derivative(gray: jax.Array) -> jax.Array:
    """uint8 (...,H,W) → float32, negated central difference.

    out = (I[x-1] - I[x+1]) / 2 with one-sided (still ÷2) borders —
    the reference's c1 = in[id+1], c2 = in[id-1], out = (c2-c1)/2
    (costVolume.cu:362-378).  Half-integers: exact in float32.
    """
    g = gray.astype(jnp.int32)
    c1 = jnp.concatenate([g[..., 1:], g[..., -1:]], axis=-1)  # in[id+1]; edge: in[id]
    c2 = jnp.concatenate([g[..., :1], g[..., :-1]], axis=-1)  # in[id-1]; edge: in[id]
    return (c2 - c1).astype(jnp.float32) * jnp.float32(0.5)
