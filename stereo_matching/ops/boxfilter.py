"""Integral image + clamped-window box mean — gather-free, batched.

Reference:
  * rowSum / colSum integral image     integral.cu:78-90, 121-131
  * computeBoxFilterOnGPU/MeanOnGPU    guidedFilter.cu:297-318

The reference launches ONE thread per row/col with a serial scan (91% of
its device time) and round-trips every integral through host memory
(guidedFilter.cu:67-82).  Here the whole thing is a device-resident XLA
graph: two cumsums + four *static slices* of an edge-padded integral —
no gathers, no host syncs, and it batches over arbitrary leading axes
(all disparity slices at once).

Window semantics (guidedFilter.cu:305-318):
  ymin = max(-1, y-R-1), ymax = min(h-1, y+R)   (ditto x)
  sum  = S[ymax,xmax] - S[ymax,xmin] - S[ymin,xmax] + S[ymin,xmin]
         (terms with index -1 are 0)
  mean = sum / ((xmax-xmin) * (ymax-ymin))      ← *clamped* area

With Sp the (H+1, W+1) zero-top-left-padded integral, the four taps are
Sp[min(h, y+R+1), ...] / Sp[max(0, y-R), ...].  Edge-padding Sp by R on
every side turns all four clamped taps into static slices:
  B = pad(Sp, R, mode=edge) ⇒ B[a, b] = Sp[clip(a-R, 0, h), clip(b-R, 0, w)]
  tap_tl = B[y, x]                 tap_br = B[y+2R+1, x+2R+1]
  tap_bl = B[y+2R+1, x]            tap_tr = B[y, x+2R+1]
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Largest finite float32.  min(x, FLT_MAX) is the identity for every
# finite x (and NaN-propagating), but neither XLA nor LLVM can fold it
# away, so it forces the operand to be materialized with ordinary f32
# rounding.  Used to stop FMA contraction of a*b followed by ±c: XLA's
# backends may contract (no flag disables it), which would silently
# change results vs the sequential oracle.
_FLT_MAX = float.fromhex("0x1.fffffep+127")


def strict_mul(a, b):
    """a*b with guaranteed float32 rounding (immune to FMA contraction
    with a downstream add/sub)."""
    return jnp.minimum(a * b, jnp.float32(_FLT_MAX))


def exact_div(a, b):
    """a / b rounded once to float32, as IEEE division rounds it.  XLA
    lowers float32 division on the GPU to an approximate instruction
    (PTX div.full.f32, up to 2 ulp off), so this divides in float64 and
    rounds back: a correctly rounded 53-bit quotient of two float32s
    rounds to the correctly rounded float32 quotient (53 >= 2*24 + 2)."""
    with jax.enable_x64(True):
        q = jnp.asarray(a).astype(jnp.float64) / jnp.asarray(b).astype(jnp.float64)
    return q.astype(jnp.float32)


def _seq_cumsum(x: jax.Array, axis: int) -> jax.Array:
    """Strictly sequential (left-to-right association) float32 cumsum —
    bit-identical to the reference's serial rowSum/colSum loops
    (integral.cu:78-90, 121-131)."""
    xs = jnp.moveaxis(x, axis, 0)

    def step(carry, v):
        carry = carry + v
        return carry, carry

    _, ys = jax.lax.scan(step, jnp.zeros_like(xs[0]), xs)
    return jnp.moveaxis(ys, 0, axis)


def integral_image(img: jax.Array, exact: bool = False) -> jax.Array:
    """float32 (..., H, W) → 2-D inclusive prefix sum over the last two
    axes (rowSum then colSum, integral.cu:78-131).

    ``exact=False`` (default) lets XLA reassociate the cumsum (fast,
    parallel; float results agree with the sequential order to
    ~ulp·log2(n)).  ``exact=True`` forces the reference's sequential
    association — the parity-test mode."""
    if exact:
        return _seq_cumsum(_seq_cumsum(img, img.ndim - 1), img.ndim - 2)
    s = jnp.cumsum(img, axis=-1, dtype=jnp.float32)
    return jnp.cumsum(s, axis=-2, dtype=jnp.float32)


def window_area(h: int, w: int, radius: int) -> jax.Array:
    """float32 (H, W) clamped window area (xmax-xmin)(ymax-ymin)
    (guidedFilter.cu:314-317).  Interior value (2R+1)²."""
    y = jnp.arange(h, dtype=jnp.int32)
    x = jnp.arange(w, dtype=jnp.int32)
    ay = jnp.minimum(h - 1, y + radius) - jnp.maximum(-1, y - radius - 1)
    ax = jnp.minimum(w - 1, x + radius) - jnp.maximum(-1, x - radius - 1)
    return (ay[:, None] * ax[None, :]).astype(jnp.float32)


def box_sum(img: jax.Array, radius: int, exact: bool = False) -> jax.Array:
    """Clamped-window box *sum* over the last two axes."""
    h, w = img.shape[-2], img.shape[-1]
    r = radius
    s = integral_image(img, exact=exact)
    nbatch = img.ndim - 2
    pad0 = ((0, 0),) * nbatch
    # zero pad on top/left (the "-1 index reads 0" rule) …
    sp = jnp.pad(s, pad0 + ((1, 0), (1, 0)))
    # … then edge pad by R on every side (the clamping rule).
    b = jnp.pad(sp, pad0 + ((r, r), (r, r)), mode="edge")
    k = 2 * r + 1
    sl = lambda y0, x0: b[..., y0 : y0 + h, x0 : x0 + w]
    return sl(k, k) - sl(k, 0) - sl(0, k) + sl(0, 0)


def box_mean(
    img: jax.Array,
    radius: int,
    area: jax.Array | None = None,
    exact: bool = False,
) -> jax.Array:
    """Clamped-window box mean (computeMeanOnGPU, guidedFilter.cu:305-318).

    ``area`` may be passed in to share the (H, W) normalizer across many
    calls (it only depends on shape and radius).  ``exact`` also divides
    with exact_div.
    """
    if area is None:
        area = window_area(img.shape[-2], img.shape[-1], radius)
    s = box_sum(img, radius, exact=exact)
    # parity mode needs the reference's correctly rounded f32 division
    return exact_div(s, area) if exact else s / area
