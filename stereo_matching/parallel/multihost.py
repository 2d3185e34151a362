"""Multi-host execution: jax.distributed + host-local frame feeding.

The scale-out story for image-sequence throughput (BASELINE.json
config #5): each host decodes its own frames (native/stereoio), the
global mesh puts the 'b' axis across hosts (frames never cross hosts),
and 'd','y','x' stay within a host's devices so halo exchanges and the
WTA combine ride the host's own interconnect.

Single-process use degrades gracefully: ``initialize()`` is a no-op and
``from_host_batches`` is a device_put.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import make_mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """jax.distributed.initialize wrapper; no-op when single-process
    (with no arguments, JAX auto-detects a cluster environment where
    one exists).

    With explicit arguments every failure propagates — a half-failed
    cluster init must not silently degrade to single-process.  With no
    arguments, only the specific "no cluster environment detected"
    ValueError is treated as the single-process case."""
    if num_processes is not None and num_processes <= 1:
        return
    if coordinator_address is None and num_processes is None:
        try:
            jax.distributed.initialize()
        except ValueError as e:
            # auto-detection found NO cluster at all (plain
            # single-process run) raises exactly this; a PARTIAL
            # cluster env ("Number of processes must be defined.",
            # "process id ... must be defined.") propagates — it must
            # not silently degrade to single-process
            if "coordinator_address should be defined" in str(e):
                return
            raise
        return
    jax.distributed.initialize(coordinator_address, num_processes, process_id)


def pod_mesh(frames_per_host: int = 1, y: int = 1, x: int = 1, d: int = 1) -> Mesh:
    """Mesh over every device of every process, with the 'b' axis sized
    num_hosts * frames_per_host so batch parallelism spans hosts."""
    n_hosts = jax.process_count()
    b = n_hosts * frames_per_host
    need = b * y * x * d
    if need != len(jax.devices()):
        raise ValueError(
            f"mesh {b}x{d}x{y}x{x} = {need} devices != available {len(jax.devices())}")
    return make_mesh(b, y, x, d)


def from_host_batches(mesh: Mesh, local_left: np.ndarray, local_right: np.ndarray):
    """Build global (B,H,W,C) arrays from each host's local frames
    without gathering them (frames stay on the host that decoded them)."""
    spec = P("b", None, None, None)
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return (jax.device_put(local_left, sharding),
                jax.device_put(local_right, sharding))
    gl = jax.make_array_from_process_local_data(sharding, local_left)
    gr = jax.make_array_from_process_local_data(sharding, local_right)
    return gl, gr
