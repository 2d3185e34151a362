"""Pure-NumPy golden oracle for the stereo pipeline.

This module is the *parity contract*: a sequential, bit-faithful NumPy
re-statement of the reference semantics (hamza1030/stereo_matching_cuda).
Every function documents the reference code it mirrors (file:line under
the reference repository).  The device ops in ``stereo_matching.ops``
are tested against this oracle.

Float behavior notes (all verified against the CUDA/C sources):
  * All pipeline buffers are float32; accumulation order is preserved
    (np.cumsum is sequential, matching rowSum/colSum integral.cu:78-131).
  * ``1.0f / (var + EPS)`` promotes to double because ``EPS`` is a double
    literal, then rounds back to float on assignment
    (guidedFilter.cu:350) — emulated with a float64 round trip.
  * Grayscale accumulates in double and truncates (rgb_to_grayscale.cu:9-10).
  * ``memset(best_cost, 9999999.0f, ...)`` fills bytes 0x7F, so the float
    init is 0x7F7F7F7F ≈ 3.3961514e38 (main.cu:112-115) — functionally +inf.
"""

from __future__ import annotations

import numpy as np

from .config import StereoConfig, DEFAULT_CONFIG

# The accidental "+infinity": bytes 0x7F7F7F7F as a float (main.cu:112).
BEST_COST_INIT = np.frombuffer(b"\x7f\x7f\x7f\x7f", dtype="<f4")[0]


# ----------------------------------------------------------------------
# Grayscale (rgb_to_grayscale.cu:4-23)
# ----------------------------------------------------------------------
def rgb_to_grayscale(rgb: np.ndarray, cfg: StereoConfig = DEFAULT_CONFIG) -> np.ndarray:
    """uint8 (H,W,C) → uint8 (H,W).

    ``val = R_W*r + G_W*g + B_W*b`` in double precision followed by a
    truncating ``(unsigned char)`` cast (rgb_to_grayscale.cu:9-10).  Alpha
    channels (C=4) are ignored, as in the reference.
    """
    assert rgb.dtype == np.uint8 and rgb.ndim == 3
    r = rgb[..., 0].astype(np.float64)
    g = rgb[..., 1].astype(np.float64)
    b = rgb[..., 2].astype(np.float64)
    val = cfg.r_w * r + cfg.g_w * g + cfg.b_w * b
    return val.astype(np.uint8)  # trunc toward zero (values are >= 0)


# ----------------------------------------------------------------------
# Horizontal derivative (costVolume.cu:358-381, x_derivativeOnGPU)
# ----------------------------------------------------------------------
def x_derivative(gray: np.ndarray) -> np.ndarray:
    """uint8 (H,W) → float32 (H,W), the *negated* central difference.

    Interior: (I[x-1] - I[x+1]) / 2 ;
    x == 0:   (I[x]   - I[x+1]) / 2 ;
    x == w-1: (I[x-1] - I[x]  ) / 2      (costVolume.cu:362-378, out =
    (c2 - c1)/2 with c1 = in[id+1], c2 = in[id-1]).
    """
    assert gray.dtype == np.uint8 and gray.ndim == 2
    g = gray.astype(np.int32)
    c1 = np.empty_like(g)
    c2 = np.empty_like(g)
    c1[:, :-1] = g[:, 1:]   # in[id+1]
    c1[:, -1] = g[:, -1]    # right edge: in[id]
    c2[:, 1:] = g[:, :-1]   # in[id-1]
    c2[:, 0] = g[:, 0]      # left edge: in[id]
    return ((c2 - c1).astype(np.float32)) / np.float32(2)


# ----------------------------------------------------------------------
# Cost volume (costVolume.cu:163-221, costVolumOnGPU2)
# ----------------------------------------------------------------------
def cost_volume(
    i1: np.ndarray,
    i2: np.ndarray,
    dmin: int,
    cfg: StereoConfig = DEFAULT_CONFIG,
    der1: np.ndarray | None = None,
    der2: np.ndarray | None = None,
) -> np.ndarray:
    """uint8 (H,W) x2 → float32 (D,H,W) truncated AD + gradient-AD cost.

    cost[s, y, x] = (1-α)·min(|i1 - i2(x+d)|, TH_color)
                  + α·min(|∇1 - ∇2(x+d)|, TH_grad),   d = dmin + s,
    and the out-of-range constant (1-α)·TH_color + α·TH_grad = 2.5 when
    x+d ∉ [0, w2) (costVolume.cu:184-188).
    """
    h, w1 = i1.shape
    w2 = i2.shape[1]
    if der1 is None:
        der1 = x_derivative(i1)
    if der2 is None:
        der2 = x_derivative(i2)
    alpha = np.float32(cfg.alpha)
    th_color = np.float32(cfg.th_color)
    th_grad = np.float32(cfg.th_grad)
    one = np.float32(1)
    oob = (one - alpha) * th_color + alpha * th_grad

    g1 = i1.astype(np.int32)
    g2 = i2.astype(np.int32)
    x = np.arange(w1)
    out = np.empty((cfg.size_d, h, w1), dtype=np.float32)
    for s in range(cfg.size_d):
        d = dmin + s
        xs = x + d
        valid = (xs >= 0) & (xs < w2)
        xc = np.clip(xs, 0, w2 - 1)
        diff = np.abs(g1 - g2[:, xc]).astype(np.float32)
        grad = np.abs(der1 - der2[:, xc]).astype(np.float32)
        c = (one - alpha) * np.minimum(diff, th_color) + alpha * np.minimum(grad, th_grad)
        out[s] = np.where(valid[None, :], c, oob)
    return out


# ----------------------------------------------------------------------
# Integral image (integral.cu:78-131: rowSum then colSum, float32 serial)
# ----------------------------------------------------------------------
def integral_image(img: np.ndarray) -> np.ndarray:
    """float32 (H,W) → float32 (H,W) 2-D inclusive prefix sum.

    Row-wise cumulative sum followed by column-wise cumulative sum, in
    float32 with sequential accumulation order — identical association to
    rowSum/colSum (integral.cu:78-90,121-131).
    """
    assert img.dtype == np.float32
    return np.cumsum(np.cumsum(img, axis=1, dtype=np.float32), axis=0, dtype=np.float32)


# ----------------------------------------------------------------------
# Box mean from integral (guidedFilter.cu:297-318)
# ----------------------------------------------------------------------
def box_mean(img: np.ndarray, radius: int) -> np.ndarray:
    """Clamped-window box mean via integral image.

    ymin = max(-1, y-R-1), ymax = min(h-1, y+R) (ditto x); the sum of the
    window is a 4-tap integral difference and the normalizer is the
    *actual* clamped area (xmax-xmin)(ymax-ymin)
    (guidedFilter.cu:305-318).  Zero-padding the integral at index -1
    reproduces the reference's conditional adds exactly (subtracting an
    exact 0.0 is a no-op in IEEE arithmetic).
    """
    assert img.dtype == np.float32
    h, w = img.shape
    s = integral_image(img)
    sp = np.zeros((h + 1, w + 1), dtype=np.float32)
    sp[1:, 1:] = s
    y = np.arange(h)[:, None]
    x = np.arange(w)[None, :]
    ymin = np.maximum(-1, y - radius - 1)
    ymax = np.minimum(h - 1, y + radius)
    xmin = np.maximum(-1, x - radius - 1)
    xmax = np.minimum(w - 1, x + radius)
    val = (
        sp[ymax + 1, xmax + 1]
        - sp[ymax + 1, xmin + 1]
        - sp[ymin + 1, xmax + 1]
        + sp[ymin + 1, xmin + 1]
    )
    area = ((xmax - xmin) * (ymax - ymin)).astype(np.float32)
    return val / area


def _fl_to_ch(img: np.ndarray) -> np.ndarray:
    """float32 → uint8: truncate toward zero, clamp > 255 to 255
    (guidedFilter.cu:451-458, flToChOnGPU)."""
    c = img.astype(np.int32)  # trunc toward zero
    c = np.where(c > 255, 255, c)
    return (c & 0xFF).astype(np.uint8)


# ----------------------------------------------------------------------
# Guided filter + streaming WTA (guidedFilter.cu:4-295,345-369,403-411)
# ----------------------------------------------------------------------
def guided_filter_wta(
    gray: np.ndarray,
    cost: np.ndarray,
    dmin: int,
    cfg: StereoConfig = DEFAULT_CONFIG,
):
    """Returns (best_cost, disparity_map, mean_uint8).

    Per view: I = float(gray); mean_I = box(I); var = box(I·I) - mean_I²
    (guidedFilter.cu:62-121).  Then for each disparity slice p:
      mean_p  = box(p)
      mean_Ip = box(I·p)
      c = 1/(var+EPS)                       [double, rounded to float]
      a = (mean_Ip - mean_I·mean_p)·c       (guidedFilter.cu:345-354)
      b = mean_p - mean_I·a
      q = box(a)·I + box(b)                 (guidedFilter.cu:363-369)
      if best >= q: {dmap = dmin+s; best = q}   # >=: largest d wins ties
                                            (guidedFilter.cu:403-411)
    best is initialized to the 0x7F7F7F7F byte-fill float (main.cu:112).
    """
    r = cfg.radius
    eps64 = np.float64(cfg.eps)
    I = gray.astype(np.float32)
    mean_i = box_mean(I, r)
    mean_u8 = _fl_to_ch(mean_i)
    var = box_mean(I * I, r) - mean_i * mean_i

    # c = (float)(1.0f / (var + EPS)) with EPS a double literal.
    c = (np.float64(1.0) / (var.astype(np.float64) + eps64)).astype(np.float32)

    best = np.full(gray.shape, BEST_COST_INIT, dtype=np.float32)
    dmap = np.zeros(gray.shape, dtype=np.float32)
    for s in range(cost.shape[0]):
        p = cost[s]
        mean_p = box_mean(p, r)
        mean_ip = box_mean(I * p, r)
        a = (mean_ip - mean_i * mean_p) * c
        b = mean_p - mean_i * a
        q = box_mean(a, r) * I + box_mean(b, r)
        upd = best >= q
        dmap[upd] = np.float32(dmin + s)
        best[upd] = q[upd]
    return best, dmap, mean_u8


# ----------------------------------------------------------------------
# LR consistency (occlusion.cu:3-15, detect_occlusionOnGPU)
# ----------------------------------------------------------------------
def detect_occlusion(
    disp_left: np.ndarray,
    disp_right: np.ndarray,
    d_occlusion: int,
    cfg: StereoConfig = DEFAULT_CONFIG,
) -> np.ndarray:
    """Mark LR-inconsistent pixels of the left map with ``d_occlusion``.

    d = (int)dispL[x] (trunc); occluded iff x+d ∉ [0,w) or
    |d + dispR[x+d]| > D_LR (occlusion.cu:8-12).  Short-circuit ``||``
    means dispR is only read in-range.
    """
    h, w = disp_left.shape
    d = np.trunc(disp_left).astype(np.int32)
    x = np.arange(w)[None, :]
    xs = x + d
    in_range = (xs >= 0) & (xs < w)
    xc = np.clip(xs, 0, w - 1)
    dprime = np.take_along_axis(disp_right, xc, axis=1)
    bad = np.abs(d.astype(np.float32) + dprime) > np.float32(cfg.d_lr)
    occl = (~in_range) | bad
    out = disp_left.copy()
    out[occl] = np.float32(d_occlusion)
    return out


# ----------------------------------------------------------------------
# Occlusion filling (occlusion.cu:134-176 / 189-229)
# ----------------------------------------------------------------------
def fill_occlusion(disp: np.ndarray, v_min: float) -> np.ndarray:
    """Fill occluded pixels with max(nearest valid left, nearest valid
    right) along the row.

    A pixel is occluded iff ``(int)disp < v_min`` (trunc cast,
    occlusion.cu:140-142); scan validity tests the *float* value
    ``>= v_min`` (occlusion.cu:152,167); either scan failing yields
    ``v_min`` (occlusion.cu:147,161).

    The reference GPU kernel reads and writes in place (a data race,
    occlusion.cu:134-176); the sequential CPU twin is
    deterministic-but-order-dependent.  For a *contiguous occluded run*
    both collapse to: every pixel of the run gets
    max(value left of the run, value right of the run) — which is exactly
    the scan-on-original semantics implemented here.  This is the defined
    deterministic behavior of this framework.
    """
    h, w = disp.shape
    out = disp.copy()
    vminf = np.float32(v_min)
    occl = np.trunc(disp).astype(np.int32) < v_min
    valid = disp >= vminf

    # nearest valid value at <= x (per row), else v_min
    idx = np.where(valid, np.arange(w)[None, :], -1)
    idx = np.maximum.accumulate(idx, axis=1)
    has_left = idx >= 0
    rows = np.arange(h)[:, None]
    dleft = np.where(has_left, disp[rows, np.maximum(idx, 0)], vminf)

    # nearest valid value at >= x (per row), else v_min
    ridx = np.where(valid, np.arange(w)[None, :], w)
    ridx = np.minimum.accumulate(ridx[:, ::-1], axis=1)[:, ::-1]
    has_right = ridx < w
    dright = np.where(has_right, disp[rows, np.minimum(ridx, w - 1)], vminf)

    fill = np.maximum(dleft, dright)
    out[occl] = fill[occl]
    return out


# ----------------------------------------------------------------------
# write_mat min-max normalizer (main.cu:13-35)
# ----------------------------------------------------------------------
def write_mat_normalize(mat: np.ndarray) -> np.ndarray:
    """Replicates write_mat's quirky min/max scan and uint8 conversion.

    The scan uses ``if (v > max) ... else if (v <= min) ...`` — an element
    that raises the running max never updates the min (main.cu:18-26).
    The final min is therefore the minimum over elements that did *not*
    break the running max (or the 1.5e8 init if none qualify).
    ``int c = (v - min) * 255.0f / (max - min)`` truncates toward zero and
    wraps through ``(unsigned char)`` (main.cu:28-30).
    """
    flat = mat.reshape(-1).astype(np.float32)
    init_max = np.float32(-150000000.0)
    init_min = np.float32(150000000.0)
    runmax = np.maximum.accumulate(np.concatenate([[init_max], flat[:-1]]).astype(np.float32))
    breaking = flat > runmax
    nonbreak = flat[~breaking]
    mx = np.float32(np.max(flat)) if np.any(flat > init_max) else init_max
    mn = np.float32(np.min(nonbreak)) if nonbreak.size and np.min(nonbreak) <= init_min else init_min
    if mx == mn:
        # constant input: the reference's expression divides by zero
        # and casts NaN to int (UB in C).  Both implementations
        # happened to produce 0 on x86; make that the defined contract
        # (the native codec guards identically).
        return np.zeros(mat.shape, np.uint8)
    with np.errstate(over="ignore", invalid="ignore"):
        # extreme inputs overflow f32 and produce NaN→0 casts exactly as
        # the C expression does — intentional, matches main.cu:28-30
        c = ((flat - mn) * np.float32(255.0)) / (mx - mn)
        ci = np.trunc(c).astype(np.int64)
    return (ci & 0xFF).astype(np.uint8).reshape(mat.shape)


# ----------------------------------------------------------------------
# Full pipeline (main.cu:37-214)
# ----------------------------------------------------------------------
def run_pipeline(rgb_left: np.ndarray, rgb_right: np.ndarray,
                 cfg: StereoConfig = DEFAULT_CONFIG) -> dict:
    """End-to-end oracle: mirrors main() including both views, the LR
    check on a copy of the left map, and the fill (main.cu:65-155)."""
    gl = rgb_to_grayscale(rgb_left, cfg)
    gr = rgb_to_grayscale(rgb_right, cfg)
    cost_l = cost_volume(gl, gr, cfg.d_min, cfg)
    cost_r = cost_volume(gr, gl, cfg.d_min_right, cfg)
    best_l, dmap_l, mean_l = guided_filter_wta(gl, cost_l, cfg.d_min, cfg)
    best_r, dmap_r, mean_r = guided_filter_wta(gr, cost_r, cfg.d_min_right, cfg)
    occ = detect_occlusion(dmap_l, dmap_r, cfg.d_occlusion, cfg)
    filled = fill_occlusion(occ, cfg.v_min)
    return {
        "gray_left": gl, "gray_right": gr,
        "cost_left": cost_l, "cost_right": cost_r,
        "best_cost_left": best_l, "best_cost_right": best_r,
        "disparity_left": dmap_l, "disparity_right": dmap_r,
        "mean_left": mean_l, "mean_right": mean_r,
        "occlusion": occ, "occlusion_filled": filled,
    }
