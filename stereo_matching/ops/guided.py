"""Guided-filter cost aggregation + winner-take-all — batched over D.

Reference: compute_guided_filter (guidedFilter.cu:4-295) runs a serial
16-iteration host loop, each iteration doing 4 host-round-trip integral
images, ~13 zero-fill memcpys and a streaming dispSelect kernel.  Per
run that is 132 rowSum + 132 colSum launches — 91% of its device time.

Here the per-view pipeline is ONE XLA graph:

  I       = float(gray)
  mean_I  = box(I);  var = box(I·I) - mean_I²          (guidedFilter.cu:62-121)
  c       = fl32(1.0 / (var + EPS))     ← f64 in the reference
                                          (guidedFilter.cu:350); emulated
                                          with double-float arithmetic
  ∀d (batched):                                        (guidedFilter.cu:171-238)
    mean_p  = box(p);  mean_Ip = box(I·p)
    a = (mean_Ip - mean_I·mean_p)·c;  b = mean_p - mean_I·a   (:345-354)
    q = box(a)·I + box(b)                                      (:363-369)
  WTA: streaming `if best >= q` with ascending d         (:403-411)
       ⇒ final d = LARGEST d attaining min_d q  (">=": last wins)

The streaming argmin is replaced by a reversed argmin over the stacked q
volume (equivalent: after the running min reaches the global min, later
updates fire only on exact ties, so the final label is the largest
arg-min).  For large D·H·W the disparity axis is processed in chunks of
``cfg.d_chunk`` under lax.scan with a (best, dmap) carry that replicates
the same ascending-order streaming semantics across chunks.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..config import StereoConfig, DEFAULT_CONFIG
from .boxfilter import box_mean, strict_mul, window_area
from .image import fl_to_ch

# The reference initializes best_cost with memset(…, 9999999.0f) which
# fills bytes 0x7F → floats of 3.3961514e38 (main.cu:112-115).  Any
# real q is smaller, so the first compare always fires; we keep the
# same constant so "never updated" pixels round-trip identically.
BEST_COST_INIT = float(np.frombuffer(b"\x7f\x7f\x7f\x7f", dtype="<f4")[0])


def _recip_var_eps(var: jax.Array, eps: float) -> jax.Array:
    """fl32(1.0 / (var_f64 + eps_f64)) without native f64.

    The reference's EPS is a double literal, so ``1.0f/(var[i]+EPS)``
    promotes to f64 and rounds the quotient back to f32 on assignment
    (guidedFilter.cu:350).  Emulated with double-float (Dekker) ops:
    var+eps as an exact two-float sum, one Newton refinement of the f32
    reciprocal ⇒ ~2^-45 relative error, then a single rounding to f32.
    Every product that feeds an add or subtract goes through strict_mul:
    Dekker's split and error terms need each product rounded on its
    own, and a backend that contracts a*b±c into an FMA would break
    them.  Checked against numpy f64 on 10^7 seeded samples
    (tests/test_cost_guided.py, chip_smoke.py): 0 mismatches.
    """
    eps_hi = jnp.float32(eps)
    eps_lo = jnp.float32(np.float64(eps) - np.float64(np.float32(eps)))
    # TwoSum(var, eps_hi): s + e == var + eps_hi exactly.
    s = var + eps_hi
    bb = s - var
    e = (var - (s - bb)) + (eps_hi - bb)
    e = e + eps_lo  # fold in the low part of eps
    # Double-float reciprocal of (s, e): y0 then one Newton step carried
    # out so the correction term keeps full f32 precision.
    y0 = jnp.float32(1.0) / s
    # r = 1 - (s+e)*y0, with the product s*y0 split exactly (Dekker):
    # p = s*y0 rounded, p_err its rounding error.
    c = jnp.float32(4097.0)  # splitter for f32 (2^12+1)
    cs = strict_mul(c, s)
    s_hi = cs - (cs - s)
    s_lo = s - s_hi
    cy = strict_mul(c, y0)
    y_hi = cy - (cy - y0)
    y_lo = y0 - y_hi
    p = strict_mul(s, y0)
    p_err = (((strict_mul(s_hi, y_hi) - p) + strict_mul(s_hi, y_lo)
              + strict_mul(s_lo, y_hi)) + strict_mul(s_lo, y_lo))
    r = ((jnp.float32(1.0) - p) - p_err) - strict_mul(e, y0)
    return y0 + strict_mul(y0, r)


def _chunk_filter(I, mean_i, c, area, cost_chunk, radius, exact=False):
    """Filter a (Dc, H, W) chunk of cost slices → q (Dc, H, W)."""
    bm = lambda x: box_mean(x, radius, area, exact=exact)
    # strict_mul: the reference rounds every product to f32 before the
    # following subtract/add (separate CUDA kernels / separate
    # statements); XLA's unconditional FMA contraction would fuse them.
    mean_p = bm(cost_chunk)
    mean_ip = bm(strict_mul(I[None], cost_chunk))
    a = (mean_ip - strict_mul(mean_i[None], mean_p)) * c[None]
    b = mean_p - strict_mul(mean_i[None], a)
    return strict_mul(bm(a), I[None]) + bm(b)


def streaming_wta(q: jax.Array):
    """(Dc,H,W) → (best, sidx): running min with LAST-wins ties
    (ascending-d streaming with `>=`, guidedFilter.cu:403-411).  Public:
    this is THE WTA tie rule, shared by every aggregation model."""
    dc = q.shape[0]
    best = jnp.min(q, axis=0)
    sidx = (dc - 1) - jnp.argmin(q[::-1], axis=0)
    return best, sidx


_chunk_wta = streaming_wta   # internal alias (historical name)


def guided_filter_wta(
    gray: jax.Array,
    cost: jax.Array,
    dmin: int,
    cfg: StereoConfig = DEFAULT_CONFIG,
):
    """Returns (best_cost f32, disparity f32, mean uint8) for one view.

    ``cost`` is the (D, H, W) volume; ``dmin`` the label offset of slice
    0 (main.cu:79-82).
    """
    r = cfg.radius
    h, w = gray.shape
    area = window_area(h, w, r)
    exact = cfg.exact_integral
    I = gray.astype(jnp.float32)
    mean_i = box_mean(I, r, area, exact=exact)
    mean_u8 = fl_to_ch(mean_i)
    var = box_mean(strict_mul(I, I), r, area, exact=exact) - strict_mul(mean_i, mean_i)
    c = _recip_var_eps(var, cfg.eps)

    size_d = cost.shape[0]
    dc = cfg.d_chunk or size_d
    if size_d % dc != 0:
        raise ValueError(f"d_chunk {dc} must divide size_d {size_d}")

    if dc == size_d:
        q = _chunk_filter(I, mean_i, c, area, cost, r, exact)
        best, sidx = _chunk_wta(q)
        dmap = (dmin + sidx).astype(jnp.float32)
        return best, dmap, mean_u8

    best, dmap = chunked_wta_scan(
        cost, dc, dmin,
        lambda chunk: _chunk_filter(I, mean_i, c, area, chunk, r, exact))
    return best, dmap, mean_u8


def chunked_wta_scan(cost, dc, dmin, chunk_q):
    """Ascending d-chunk streaming WTA: scan chunks of ``dc`` slices,
    aggregate each with ``chunk_q(chunk) -> q``, and carry (best, dmap)
    under THE ascending ``best >= q`` rule (largest d wins ties,
    guidedFilter.cu:403-411 with the ascending loop :171) — the single
    home of the cross-chunk tie semantics, shared by the guided and
    box aggregation families (review r5: was duplicated in
    models/box.py)."""
    size_d, h, w = cost.shape
    chunks = cost.reshape(size_d // dc, dc, h, w)
    starts = jnp.arange(size_d // dc, dtype=jnp.int32) * dc

    def step(carry, xs):
        best0, dmap0 = carry
        chunk, start = xs
        bestc, sidx = _chunk_wta(chunk_q(chunk))
        upd = best0 >= bestc
        return (jnp.where(upd, bestc, best0),
                jnp.where(upd, (dmin + start + sidx).astype(jnp.float32),
                          dmap0)), None

    init = (jnp.full((h, w), BEST_COST_INIT, dtype=jnp.float32),
            jnp.zeros((h, w), dtype=jnp.float32))
    (best, dmap), _ = jax.lax.scan(step, init, (chunks, starts))
    return best, dmap
