"""Sharded stereo pipeline: shard_map over a ('b','y','x') mesh.

Decomposition (SURVEY.md §2.3 — designed, not mirrored; the reference is
single-GPU):

  * 'b'  — batch of frames (data parallel, zero communication)
  * 'y','x' — spatial tile grid with ONE halo exchange of the grayscale
    images per frame (halo = disparity shift + derivative + 2 chained
    box-filter radii, see parallel.mesh.pipeline_halo), after which the
    whole cost-volume + guided-filter + WTA chain is tile-local
  * LR check — a second, 15-px halo exchange of the two disparity maps
  * occlusion fill — two-level segmented scan: tile-local associative
    scans + all_gather of per-row tile summaries along 'x'

Border math: out-of-mesh halos arrive as ZEROS (ppermute), and all
intermediate fields are masked to zero outside the global image, so a
plain (unclamped) 4-tap window sum over the extended tile equals the
reference's border-clamped window sum; the normalizer is the
global-coordinate clamped area (guidedFilter.cu:305-318).  Tile results
are therefore exact up to integral-image float association (the integral
origin shifts per tile), which can flip exact WTA ties — tests bound the
mismatch count vs the single-chip result.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
try:                                   # jax >= 0.8 top-level API
    from jax import shard_map as _shard_map

    def shard_map(f, *, mesh, in_specs, out_specs, check_rep):
        return _shard_map(f, mesh=mesh, in_specs=in_specs,
                          out_specs=out_specs, check_vma=check_rep)
except ImportError:                    # older jax: check_rep kwarg
    from jax.experimental.shard_map import shard_map

from ..config import StereoConfig, DEFAULT_CONFIG
from ..ops.boxfilter import box_sum, strict_mul
from ..ops.guided import _recip_var_eps, _chunk_wta
from ..ops.image import rgb_to_grayscale, fl_to_ch
from ..ops.shifts import shift_cols
from .halo import halo_exchange
from .mesh import pipeline_halo


def _global_area(gy: jax.Array, gx: jax.Array, h: int, w: int, r: int) -> jax.Array:
    """Clamped window area at global coords (guidedFilter.cu:314-317)."""
    ay = jnp.minimum(h - 1, gy + r) - jnp.maximum(-1, gy - r - 1)
    ax = jnp.minimum(w - 1, gx + r) - jnp.maximum(-1, gx - r - 1)
    return (ay[:, None] * ax[None, :]).astype(jnp.float32)


def _x_derivative_global(g: jax.Array, gx: jax.Array, w: int) -> jax.Array:
    """Negated central difference with one-sided borders at the GLOBAL
    image edges (costVolume.cu:362-378), on an extended tile."""
    gi = g.astype(jnp.int32)
    c1 = jnp.where(gx[None, :] < w - 1, shift_cols(gi, 1), gi)   # in[id+1]
    c2 = jnp.where(gx[None, :] > 0, shift_cols(gi, -1), gi)     # in[id-1]
    return (c2 - c1).astype(jnp.float32) * jnp.float32(0.5)


def _cost_slice(g1i, der1, g2s, d2s, gx, d, w, cfg, in_image):
    """One cost slice from pre-shifted right-view arrays; d may be a
    traced int (disparity-sharded mode)."""
    alpha = jnp.float32(cfg.alpha)
    th_color = jnp.float32(cfg.th_color)
    th_grad = jnp.float32(cfg.th_grad)
    one = jnp.float32(1)
    oob = (one - alpha) * th_color + alpha * th_grad
    valid = ((gx + d >= 0) & (gx + d < w))[None, :]
    diff = jnp.abs(g1i - g2s).astype(jnp.float32)
    grad = jnp.abs(der1 - d2s)
    c = strict_mul(one - alpha, jnp.minimum(diff, th_color)) + strict_mul(
        alpha, jnp.minimum(grad, th_grad))
    c = jnp.where(valid, c, oob)
    return jnp.where(in_image, c, jnp.float32(0))


def _local_cost_volume(g1, der1, g2, der2, gx, dmin, size_d, w, cfg, in_image):
    """(He,We) extended tiles → (D,He,We) cost, zeroed outside image.
    dmin is STATIC here (static column shifts)."""
    g1i = g1.astype(jnp.int32)
    g2i = g2.astype(jnp.int32)
    slices = []
    for s in range(size_d):
        d = dmin + s
        slices.append(_cost_slice(
            g1i, der1, shift_cols(g2i, d), shift_cols(der2, d),
            gx, d, w, cfg, in_image))
    return jnp.stack(slices, axis=0)


def _local_cost_volume_dyn(g1, der1, g2, der2, gx, dmin_dyn, size_d, shift_max,
                           w, cfg, in_image):
    """Like _local_cost_volume but with a TRACED base disparity (the
    'd' mesh axis shards the range, so each device's dmin differs).
    Shifts use dynamic_slice on an edge-padded array."""
    g1i = g1.astype(jnp.int32)
    we = g2.shape[-1]
    pad = [(0, 0)] * (g2.ndim - 1) + [(shift_max, shift_max)]
    g2p = jnp.pad(g2.astype(jnp.int32), pad, mode="edge")
    d2p = jnp.pad(der2, pad, mode="edge")

    def shifted(arr, d):
        return jax.lax.dynamic_slice_in_dim(arr, shift_max + d, we, axis=arr.ndim - 1)

    slices = []
    for s in range(size_d):
        d = dmin_dyn + s
        slices.append(_cost_slice(
            g1i, der1, shifted(g2p, d), shifted(d2p, d), gx, d, w, cfg, in_image))
    return jnp.stack(slices, axis=0)


def _local_guided_wta(g_ext, cost, area, in_image, cfg):
    """Extended-tile guided filter: returns the UNCROPPED per-slice
    filtered costs ``q`` (D, he, we) and the float guide mean — the
    caller crops to the tile interior and runs the WTA/label logic
    (it owns the disparity base under 'd' sharding)."""
    r = cfg.radius
    I = g_ext.astype(jnp.float32)  # zeros outside image (zero halos)
    mean_i = box_sum(I, r) / area
    var = box_sum(strict_mul(I, I), r) / area - strict_mul(mean_i, mean_i)
    c = _recip_var_eps(var, cfg.eps)

    mean_p = box_sum(cost, r) / area
    mean_ip = box_sum(strict_mul(I[None], cost), r) / area
    a = (mean_ip - strict_mul(mean_i[None], mean_p)) * c[None]
    b = mean_p - strict_mul(mean_i[None], a)
    zero = jnp.float32(0)
    a = jnp.where(in_image[None], a, zero)
    b = jnp.where(in_image[None], b, zero)
    q = strict_mul(box_sum(a, r) / area, I[None]) + box_sum(b, r) / area
    return q, mean_i


def _combine_d_shards(best, dmap, nd):
    """Cross-chip WTA combine over the 'd' mesh axis: all_gather the
    per-range winners and merge in ASCENDING range order with the
    reference's streaming `best >= q` rule (largest d wins ties,
    guidedFilter.cu:403-411)."""
    bests = jax.lax.all_gather(best, "d")     # (nd, ...)
    dmaps = jax.lax.all_gather(dmap, "d")
    best, dmap = bests[0], dmaps[0]
    for k in range(1, nd):
        upd = best >= bests[k]
        best = jnp.where(upd, bests[k], best)
        dmap = jnp.where(upd, dmaps[k], dmap)
    return best, dmap


def _segmented_fill(occ, v_min, tx, d_min, n_labels):
    """Cross-tile occlusion fill along 'x' (occlusion.cu:134-176
    semantics, race-free scan definition — see ops.occlusion).  Local
    scans use the packed-cummax form (disparity maps carry integer
    labels); tile summaries combine over an all_gather."""
    from ..ops.occlusion import _last_valid_packed

    vminf = jnp.float32(v_min)
    occl = occ.astype(jnp.int32) < v_min
    valid = occ >= vminf
    lv, lf = _last_valid_packed(occ, valid, d_min, n_labels, reverse=False)
    rv, rf = _last_valid_packed(occ, valid, d_min, n_labels, reverse=True)

    if tx > 1:
        my = jax.lax.axis_index("x")
        # forward carries: each tile's LAST (value, found) per row
        lsum_v = jax.lax.all_gather(lv[..., -1], "x")   # (tx, B, Hl)
        lsum_f = jax.lax.all_gather(lf[..., -1], "x")
        cv = jnp.zeros_like(lsum_v[0])
        cf = jnp.zeros_like(lsum_f[0])
        for k in range(tx - 1):  # combine tiles strictly left of mine
            take = (jnp.int32(k) < my) & lsum_f[k]
            cv = jnp.where(take, lsum_v[k], cv)
            cf = cf | take
        lv = jnp.where(lf, lv, cv[..., None])
        lf = lf | cf[..., None]
        # backward carries: each tile's FIRST (value, found) per row
        rsum_v = jax.lax.all_gather(rv[..., 0], "x")
        rsum_f = jax.lax.all_gather(rf[..., 0], "x")
        cv = jnp.zeros_like(rsum_v[0])
        cf = jnp.zeros_like(rsum_f[0])
        for k in range(tx - 1, 0, -1):  # tiles strictly right of mine
            take = (jnp.int32(k) > my) & rsum_f[k]
            cv = jnp.where(take, rsum_v[k], cv)
            cf = cf | take
        rv = jnp.where(rf, rv, cv[..., None])
        rf = rf | cf[..., None]

    dleft = jnp.where(lf, lv, vminf)
    dright = jnp.where(rf, rv, vminf)
    return jnp.where(occl, jnp.maximum(dleft, dright), occ)


def sharded_stereo_pipeline(
    rgb_left: jax.Array,
    rgb_right: jax.Array,
    mesh: Mesh,
    cfg: StereoConfig = DEFAULT_CONFIG,
) -> dict:
    """(B,H,W,C) uint8 pair, sharded P('b','y','x') → dict of sharded
    (B,H,W) outputs (disparity_left/right, occlusion, occlusion_filled,
    best_cost_left, mean_left)."""
    B, H, W = rgb_left.shape[:3]
    f = _build_sharded(mesh, cfg, B, H, W)
    dmap_l, dmap_r, occ, filled, best_l, mean_l = f(rgb_left, rgb_right)
    return {
        "disparity_left": dmap_l,
        "disparity_right": dmap_r,
        "occlusion": occ,
        "occlusion_filled": filled,
        "best_cost_left": best_l,
        "mean_left": mean_l,
    }


@functools.lru_cache(maxsize=64)
def _build_sharded(mesh: Mesh, cfg: StereoConfig, B: int, H: int, W: int):
    """Cached jitted shard_map pipeline for (mesh, cfg, shape).

    Building (and jitting) a fresh shard_map closure per call would miss
    the jit cache and re-trace + re-compile the whole sharded graph on
    every call.  Mesh and StereoConfig are both hashable, so the builder
    caches the jitted callable."""
    nb, ty, tx = (mesh.shape[a] for a in ("b", "y", "x"))
    nd = mesh.shape.get("d", 1)
    if B % nb or H % ty or W % tx:
        raise ValueError(f"shape {(B, H, W)} not divisible by mesh {(nb, ty, tx)}")
    hl, wl = H // ty, W // tx
    halo_y, halo_x = pipeline_halo(cfg)
    if cfg.exact_integral:
        raise ValueError(
            "exact_integral is the single-chip parity mode; sharded tiles "
            "use per-tile integral origins and are tolerance-level by "
            "design (see tests/test_sharded.py)")
    if hl < halo_y or wl < halo_x:
        raise ValueError(
            f"tile {hl}x{wl} smaller than pipeline halo {halo_y}x{halo_x}; "
            f"use fewer tiles along that axis (halo exchange is single-hop)")
    size_d = cfg.size_d
    if size_d % nd:
        raise ValueError(f"size_d {size_d} not divisible by d-axis size {nd}")
    d_per = size_d // nd
    shift = 0 - min(cfg.d_min, cfg.d_min_right)
    shift_max = cfg.shift_max

    def local_fn(rgbl, rgbr):
        # rgbl/rgbr: (Bl, hl, wl, C)
        gl = rgb_to_grayscale(rgbl, cfg)
        gr = rgb_to_grayscale(rgbr, cfg)

        def extend(g):
            g = halo_exchange(g, halo_y, "y", ty, dim=1)
            return halo_exchange(g, halo_x, "x", tx, dim=2)

        gle, gre = extend(gl), extend(gr)
        y0 = jax.lax.axis_index("y") * hl
        x0 = jax.lax.axis_index("x") * wl
        gy = y0 - halo_y + jnp.arange(hl + 2 * halo_y, dtype=jnp.int32)
        gx = x0 - halo_x + jnp.arange(wl + 2 * halo_x, dtype=jnp.int32)
        in_image = ((gy >= 0) & (gy < H))[:, None] & ((gx >= 0) & (gx < W))[None, :]
        area = _global_area(gy, gx, H, W, cfg.radius)
        crop = lambda t: t[..., halo_y : halo_y + hl, halo_x : halo_x + wl]

        # disparity-range sharding: device k on the 'd' axis owns
        # slices [k*d_per, (k+1)*d_per); the per-range winners are
        # all_gathered and combined in ascending order, replicating the
        # reference's streaming `best >= q` rule across chips.
        d_idx = jax.lax.axis_index("d") if nd > 1 else 0

        def view(g1e, g2e, dmin):
            def per_frame(g1f, g2f):
                der1 = _x_derivative_global(g1f, gx, W)
                der2 = _x_derivative_global(g2f, gx, W)
                if nd == 1:
                    cost = _local_cost_volume(
                        g1f, der1, g2f, der2, gx, dmin, size_d, W, cfg, in_image)
                    dmin_loc = dmin
                else:
                    dmin_loc = dmin + d_idx * d_per
                    cost = _local_cost_volume_dyn(
                        g1f, der1, g2f, der2, gx, dmin_loc, d_per, shift_max,
                        W, cfg, in_image)
                q, mean_i = _local_guided_wta(g1f, cost, area, in_image, cfg)
                best, sidx = _chunk_wta(crop(q))
                dmap = (dmin_loc + sidx).astype(jnp.float32)
                return best, dmap, fl_to_ch(crop(mean_i))

            best, dmap, mean = jax.vmap(per_frame)(g1e, g2e)
            if nd > 1:
                best, dmap = _combine_d_shards(best, dmap, nd)
            return best, dmap, mean

        best_l, dmap_l, mean_l = view(gle, gre, cfg.d_min)
        best_r, dmap_r, _ = view(gre, gle, cfg.d_min_right)

        # --- LR consistency + fill ---------------------------------
        # select over static shifts (the LR check's gather-free form,
        # as in ops.occlusion); the x-halo covers every label's reach,
        # so each label is a static slice of dre
        dre = halo_exchange(dmap_r, shift, "x", tx, dim=2)
        gx_t = x0 + jnp.arange(wl, dtype=jnp.int32)
        d = dmap_l.astype(jnp.int32)
        xs = gx_t[None, None, :] + d
        in_range = (xs >= 0) & (xs < W)
        dprime = jnp.zeros_like(dmap_l)
        for lab in cfg.disparities():
            # dre column (local x + shift + lab); shift + lab ∈ [0, 2*shift]
            sl = jax.lax.slice_in_dim(dre, shift + lab, shift + lab + wl, axis=2)
            dprime = jnp.where(d == lab, sl, dprime)
        bad = jnp.abs(d.astype(jnp.float32) + dprime) > jnp.float32(cfg.d_lr)
        occ = jnp.where((~in_range) | bad, jnp.float32(cfg.d_occlusion), dmap_l)

        filled = _segmented_fill(occ, cfg.v_min, tx, cfg.d_min, cfg.size_d)
        return dmap_l, dmap_r, occ, filled, best_l, mean_l

    spec_in = P("b", "y", "x", None)
    spec_out = P("b", "y", "x")
    f = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(spec_in, spec_in),
        out_specs=(spec_out,) * 6,
        check_rep=False,  # outputs are replicated over 'd' by the
                          # all_gather combine; the checker can't see it
    )
    return jax.jit(f)
