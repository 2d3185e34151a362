"""Mesh construction and halo-size computation."""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

from ..config import StereoConfig


def make_mesh(b: int = 1, y: int = 1, x: int = 1, d: int = 1, devices=None) -> Mesh:
    """Mesh over ('b','d','y','x') = batch × disparity-range × tile-row ×
    tile-col.

    The axes follow the algorithm: 'x' carries the most frequent
    collective (the x-halo exchanges of the disparity shift and the LR
    check along epipolar lines), 'y' the y-halo, 'd' only the final
    all_gather of per-range (best, dmap) pairs and 'b' nothing.  On
    cards joined all to all (NVLink) every placement costs the same.
    """
    if devices is None:
        devices = jax.devices()
    n = b * d * y * x
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    arr = np.asarray(devices[:n]).reshape(b, d, y, x)
    return Mesh(arr, ("b", "d", "y", "x"))


def pipeline_halo(cfg: StereoConfig) -> tuple[int, int]:
    """(halo_y, halo_x) needed so a tile+halo region contains every
    input of the full per-pixel pipeline:

      x: max |d| disparity shift (cost volume reads I2[x+d],
         costVolume.cu:187) + 1 (x-derivative stencil, costVolume.cu:364)
         + 2·(R+1) (two chained box filters: q = box(a(box(p))),
         guidedFilter.cu:171-238)
      y: 2·(R+1)
    """
    shift = cfg.shift_max
    box2 = 2 * (cfg.radius + 1)
    return box2, shift + 1 + box2
