"""Multi-chip execution layer: device meshes, halo exchange, sharded
stereo pipeline.

The reference is strictly single-GPU (cudaSetDevice(0), main.cu:44-48;
SURVEY.md §2.3) — this layer has no reference counterpart to mirror.
It is a `jax.sharding.Mesh` over axes

  ('b', 'd', 'y', 'x')   batch of frames × disparity ranges × spatial
                         tile grid

with `shard_map`-level halo exchange (`ppermute`) for the
stencil reach of the pipeline (disparity shift + derivative + two
box-filter radii), and a two-level segmented scan (`all_gather` of
per-tile summaries) for the cross-tile occlusion fill.
"""

from .mesh import make_mesh, pipeline_halo
from .sharded import sharded_stereo_pipeline
from .multihost import initialize, pod_mesh, from_host_batches

__all__ = [
    "make_mesh",
    "pipeline_halo",
    "sharded_stereo_pipeline",
    "initialize",
    "pod_mesh",
    "from_host_batches",
]
