"""Dense stereo engine.

A from-scratch JAX/XLA re-design of the cost-volume stereo
pipeline with guided-filter aggregation implemented by the CUDA
reference (hamza1030/stereo_matching_cuda): grayscale conversion →
per-disparity matching cost → guided-filter aggregation → winner-take-all
disparity selection → left-right consistency check → occlusion filling.

Layout:
  config     — frozen StereoConfig (reference #defines as defaults)
  reference  — sequential NumPy golden oracle (the parity contract)
  ops        — jnp/lax device ops, batched over disparity
  pipeline   — jitted end-to-end single-chip pipeline (+ batch vmap)
  parallel   — mesh/shard_map multi-chip pipeline (halo exchange,
               disparity-sharded WTA, multi-host batching)
  metrics    — bad-N / EPE / occlusion statistics
  profiling  — per-stage device timing + jax.profiler tracing
  utils      — image I/O (native C++ codec with Python fallback)
"""

from .config import StereoConfig, DEFAULT_CONFIG  # noqa: F401
from .pipeline import compute_disparity  # noqa: F401

__version__ = "0.1.0"
