"""Worker process for tests/test_multiprocess.py — one of N
jax.distributed processes running the sharded pipeline on a pod mesh.

Run as:  python tests/_mh_worker.py <process_id> <num_processes> <port>
with the CPU env (JAX_PLATFORMS=cpu, 4 forced host devices) set by the
launching test BEFORE interpreter start.
"""

import sys

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

import jax

jax.config.update("jax_platforms", "cpu")
# cross-process collectives on the CPU backend need gloo (the default
# single-process CPU client has no cross-host transport)
jax.config.update("jax_cpu_collectives_implementation", "gloo")

import numpy as np
import jax.numpy as jnp

from stereo_matching.config import StereoConfig
from stereo_matching.parallel import multihost
from stereo_matching.parallel.sharded import sharded_stereo_pipeline
from stereo_matching.pipeline import stereo_pipeline

multihost.initialize(f"localhost:{port}", nproc, pid)
assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == 4 * nproc, len(jax.devices())

# 'b' across processes (the DCN axis), 'y','x' within a process (ICI)
mesh = multihost.pod_mesh(frames_per_host=1, y=2, x=2)
cfg = StereoConfig()

H, W = 64, 96
yy, xx = np.mgrid[0:H, 0:W]


def make_frame(seed: int) -> np.ndarray:
    """Deterministic smooth frame (few WTA near-ties) distinct per host."""
    rng = np.random.default_rng(seed)
    base = 84.0 + 60.0 * np.sin(xx / 7.0 + seed) + 50.0 * np.cos(yy / 9.0)
    img = np.stack([base, base * 0.8 + 20.0, base * 0.5 + 40.0], axis=-1)
    return np.clip(img + rng.normal(0, 2, img.shape), 0, 255).astype(np.uint8)


left_local = make_frame(10 + pid)[None]            # this host's frame only
right_local = np.roll(left_local, 5, axis=2)
gl, gr = multihost.from_host_batches(mesh, left_local, right_local)
out = sharded_stereo_pipeline(gl, gr, mesh, cfg)

# every host can compute every host's EXPECTED frame (deterministic
# generator) with the single-chip pipeline; compare local shards only
expected = {}
for b in range(nproc):
    el = make_frame(10 + b)
    er = np.roll(el, 5, axis=1)
    expected[b] = np.asarray(
        stereo_pipeline(jnp.asarray(el), jnp.asarray(er), cfg)[
            "occlusion_filled"])

checked = 0
for shard in out["occlusion_filled"].addressable_shards:
    sl = shard.index
    b = sl[0].start or 0
    got = np.asarray(shard.data)[0]
    exp = expected[b][sl[1], sl[2]]
    mism = int((got != exp).sum())
    assert mism <= max(5, got.size // 500), (
        f"proc {pid} shard b={b} {sl}: {mism}/{got.size} mismatches")
    checked += 1
assert checked == 4, checked  # 4 local devices -> 4 local shards
print(f"MH_OK proc {pid}: {checked} shards verified", flush=True)
