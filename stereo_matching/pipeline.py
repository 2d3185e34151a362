"""End-to-end stereo pipeline — one jitted XLA graph per frame.

Mirrors the reference driver main() (main.cu:37-214): grayscale both
views → cost volumes (left d∈[D_MIN,D_MAX], right d∈[-D_MAX,-D_MIN]) →
guided-filter aggregation + WTA per view → LR consistency check on the
left map → occlusion fill.  Unlike the reference (1,533 host↔device
copies per frame), the whole frame is a single device computation; the
only transfers are the two input images in and the requested outputs
out.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .config import StereoConfig, DEFAULT_CONFIG
from . import ops


def _post(dmap_l, dmap_r, cfg: StereoConfig):
    """(occlusion map, filled map): LR check, then occlusion fill."""
    occ = ops.detect_occlusion(dmap_l, dmap_r, cfg.d_occlusion, cfg)
    return occ, ops.fill_occlusion(occ, cfg.v_min, cfg)


@functools.partial(jax.jit, static_argnames=("cfg", "full_outputs"))
def stereo_pipeline(
    rgb_left: jax.Array,
    rgb_right: jax.Array,
    cfg: StereoConfig = DEFAULT_CONFIG,
    full_outputs: bool = False,
) -> dict:
    """uint8 (H,W,C) ×2 → dict of outputs.

    Always returns disparity_left/right, occlusion, occlusion_filled;
    with ``full_outputs`` also the intermediates the reference writes as
    PNGs (gray, mean, best_cost, cost slice 0) — main.cu:162-181.
    """
    gl = ops.rgb_to_grayscale(rgb_left, cfg)
    gr = ops.rgb_to_grayscale(rgb_right, cfg)
    cost_l = ops.cost_volume(gl, gr, cfg.d_min, cfg)
    cost_r = ops.cost_volume(gr, gl, cfg.d_min_right, cfg)
    best_l, dmap_l, mean_l = ops.guided_filter_wta(gl, cost_l, cfg.d_min, cfg)
    best_r, dmap_r, mean_r = ops.guided_filter_wta(gr, cost_r, cfg.d_min_right, cfg)
    occ, filled = _post(dmap_l, dmap_r, cfg)
    out = {
        "disparity_left": dmap_l,
        "disparity_right": dmap_r,
        "occlusion": occ,
        "occlusion_filled": filled,
    }
    if full_outputs:
        out.update(
            gray_left=gl, gray_right=gr,
            mean_left=mean_l, mean_right=mean_r,
            best_cost_left=best_l, best_cost_right=best_r,
            cost_left_s0=cost_l[0], cost_right_s0=cost_r[0],
        )
    return out


def compute_disparity(
    rgb_left: np.ndarray,
    rgb_right: np.ndarray,
    cfg: StereoConfig = DEFAULT_CONFIG,
    full_outputs: bool = False,
    keys: tuple | None = None,
) -> dict:
    """Host-convenience wrapper: numpy in → numpy out, blocking.

    ``keys`` limits which outputs are fetched to the host: every
    fetched array is its own device→host transfer, so latency-sensitive
    callers ask only for what they return (the serving path goes
    further: compute_disparity_stacked fetches its outputs in ONE
    transfer).  The device computes all outputs either way; unfetched
    ones are simply never copied back."""
    out = stereo_pipeline(
        jnp.asarray(rgb_left), jnp.asarray(rgb_right), cfg, full_outputs)
    if keys is not None:
        missing = [k for k in keys if k not in out]
        if missing:
            raise ValueError(
                f"unknown output keys {missing}; available: {sorted(out)} "
                f"(full_outputs={full_outputs})")
        out = {k: out[k] for k in keys}
    return {k: np.asarray(v) for k, v in out.items()}


def compute_disparity_stacked(
    rgb_left: np.ndarray,
    rgb_right: np.ndarray,
    cfg: StereoConfig = DEFAULT_CONFIG,
    keys: tuple = ("occlusion_filled", "occlusion"),
    compact: bool = False,
) -> dict:
    """compute_disparity(keys=...) with ONE device→host transfer: the
    requested outputs (same shape/dtype — the disparity-map family)
    are stacked on device and fetched together; the serving path uses
    this.

    ``compact`` additionally casts the stack to int16 on device and
    back to float32 on the host — EXACT for the disparity-map family
    (WTA labels and the d_occlusion sentinel are small integers; the
    widest supported range is d_min=-32667's sentinel) — halving the
    transferred bytes."""
    out = stereo_pipeline(jnp.asarray(rgb_left), jnp.asarray(rgb_right), cfg)
    missing = [k for k in keys if k not in out]
    if missing:
        raise ValueError(
            f"unknown output keys {missing}; available: {sorted(out)}")
    stacked = jnp.stack([out[k] for k in keys])
    # the int16 cast is exact only while every emittable value fits:
    # labels in [d_min, d_max] and the d_occlusion sentinel (d_min-100)
    if compact and cfg.d_occlusion >= -32768 and cfg.d_max <= 32767:
        arr = np.asarray(stacked.astype(jnp.int16)).astype(np.float32)
    else:
        arr = np.asarray(stacked)
    return {k: arr[i] for i, k in enumerate(keys)}


@functools.partial(jax.jit, static_argnames=("cfg",))
def stereo_pipeline_batch(
    rgb_left: jax.Array,
    rgb_right: jax.Array,
    cfg: StereoConfig = DEFAULT_CONFIG,
) -> dict:
    """Sequence throughput on one device: (B,H,W,C) pairs in one graph,
    a ``vmap`` of the single-frame pipeline.  For multi-device sequence
    throughput shard the batch over the 'b' mesh axis
    (parallel.sharded_stereo_pipeline)."""
    return jax.vmap(lambda l, r: stereo_pipeline(l, r, cfg))(
        rgb_left, rgb_right)
