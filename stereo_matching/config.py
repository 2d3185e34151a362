"""Configuration for the dense stereo engine.

The reference implementation (hamza1030/stereo_matching_cuda) exposes every
tunable as a compile-time ``#define`` in ``SystemIncludes.h:6-24``.  Here they
become a frozen (hashable, jit-static) dataclass whose defaults reproduce the
reference numerics exactly:

  - ``R_W/G_W/B_W`` grayscale weights (note blue weight 0.0721, *not* the
    standard 0.114 — replicated for parity; SystemIncludes.h:7-9)
  - ``ALPHA`` gradient/color blend (SystemIncludes.h:10)
  - ``D_MIN/D_MAX`` disparity range (SystemIncludes.h:11-12)
  - ``TH_grad/TH_color`` truncation thresholds (SystemIncludes.h:13-14)
  - ``RADIUS`` box-filter radius → 19x19 window (SystemIncludes.h:21)
  - ``EPS`` guided-filter regularizer = (0.01*255)^2 (SystemIncludes.h:23)
  - ``D_LR`` left-right check tolerance (SystemIncludes.h:24)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class StereoConfig:
    """All tunables of the stereo pipeline. Hashable → usable as a jit
    static argument."""

    # Grayscale weights (SystemIncludes.h:7-9).
    r_w: float = 0.299
    g_w: float = 0.587
    b_w: float = 0.0721

    # Cost blend & truncation (SystemIncludes.h:10,13-14).
    alpha: float = 0.9
    th_color: float = 7.0
    th_grad: float = 2.0

    # Disparity search range, inclusive (SystemIncludes.h:11-12).
    d_min: int = -15
    d_max: int = 0

    # Guided filter (SystemIncludes.h:21,23).
    radius: int = 9
    eps: float = 6.5025

    # Left-right consistency tolerance (SystemIncludes.h:24).
    d_lr: int = 0

    # --- framework knobs (no reference equivalent) ---------------------
    # The filtering path is float32 by design, not configurable:
    # a = (mean_Ip - mean_I·mean_p)·c cancels catastrophically and needs
    # the full 24-bit mantissa — bf16's 8 bits would swamp the 1e-3-level
    # q gaps that decide disparities.

    # Number of disparity slices aggregated per scan step in the guided
    # filter (bounds peak device memory for large volumes). None = all
    # at once.
    d_chunk: Optional[int] = None
    # Parity mode: compute integral-image cumsums with the reference's
    # sequential left-to-right association (rowSum/colSum,
    # integral.cu:78-131) via lax.scan instead of XLA's reassociating
    # parallel cumsum.  Bit-exact vs the oracle, but serial — use for
    # validation, not production.
    exact_integral: bool = False

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.d_max < self.d_min:
            raise ValueError(f"d_max {self.d_max} < d_min {self.d_min}")
        if self.radius < 1:
            raise ValueError(f"radius must be >= 1, got {self.radius}")
        if self.eps <= 0:
            raise ValueError(f"eps must be > 0, got {self.eps}")
        if self.th_color < 0 or self.th_grad < 0:
            raise ValueError("truncation thresholds must be >= 0")
        if self.d_chunk is not None and (
            self.d_chunk < 1 or self.size_d % self.d_chunk
        ):
            raise ValueError(
                f"d_chunk {self.d_chunk} must divide size_d {self.size_d}")

    @property
    def size_d(self) -> int:
        """Number of disparity hypotheses (main.cu:70)."""
        return self.d_max - self.d_min + 1

    @property
    def d_min_right(self) -> int:
        """Disparity offset of the right view's cost volume: labels are
        ``d_min_right + s`` for slice s (main.cu:81-82)."""
        return -self.d_max

    @property
    def d_occlusion(self) -> int:
        """Sentinel written into LR-inconsistent pixels (main.cu:149)."""
        return self.d_min - 100

    @property
    def v_min(self) -> int:
        """Occlusion-fill validity threshold (main.cu:154)."""
        return self.d_min

    @property
    def window(self) -> int:
        """Box window edge length."""
        return 2 * self.radius + 1

    @property
    def shift_max(self) -> int:
        """Largest |disparity| any view samples at.  The right view's
        labels are d_min_right + s = -d_max .. -d_min, so this is just
        max(|d_min|, |d_max|) — the long 4-term max previously written
        at every halo-arithmetic site reduces to it."""
        return max(abs(self.d_min), abs(self.d_max))

    def disparities(self, dmin: Optional[int] = None) -> Tuple[int, ...]:
        base = self.d_min if dmin is None else dmin
        return tuple(base + s for s in range(self.size_d))


DEFAULT_CONFIG = StereoConfig()
