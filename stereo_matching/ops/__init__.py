"""Device ops for the dense stereo pipeline.

Each op is a pure, jittable JAX function re-deriving the semantics of a
reference CUDA kernel (see each docstring's file:line citations into
/root/reference/stereo_matching_cuda/).  Design rules:

  * static shapes, no data-dependent Python control flow;
  * gather-free where possible (static shifts / static slices instead);
  * float32 throughout, with targeted
    double-float emulation for the two places the reference computes in
    float64 (grayscale weights, the guided-filter 1/(var+EPS));
  * all-disparities-at-once batching instead of the reference's serial
    per-slice loop (guidedFilter.cu:171-238).
"""

from .image import rgb_to_grayscale, fl_to_ch, x_derivative
from .boxfilter import integral_image, box_mean, window_area
from .cost import cost_volume
from .guided import guided_filter_wta, streaming_wta, BEST_COST_INIT
from .occlusion import detect_occlusion, fill_occlusion

__all__ = [
    "streaming_wta",
    "rgb_to_grayscale",
    "fl_to_ch",
    "x_derivative",
    "integral_image",
    "box_mean",
    "window_area",
    "cost_volume",
    "guided_filter_wta",
    "BEST_COST_INIT",
    "detect_occlusion",
    "fill_occlusion",
]
