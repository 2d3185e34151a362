"""Multi-chip sharded pipeline on an 8-virtual-CPU-device mesh.

Tile results are exact up to integral-image float association (the
integral origin shifts per tile), which can flip near-tie WTA picks —
verified to be ties (best-cost deltas ≤ 1e-4 at every flipped pixel).
Real images (Tsukuba) and the rendered layered scene that stands in for
it when the reference data is not mounted flip <1e-4 of pixels;
pure-noise frames flip ~1e-3, so the oracle comparison uses the
``tsukuba`` fixture and noise frames only exercise structure (batch
consistency, mesh shapes, halo validation).
"""

import numpy as np
import jax
import pytest

from stereo_matching import reference as R
from stereo_matching.config import DEFAULT_CONFIG as CFG
from stereo_matching.parallel import make_mesh, pipeline_halo, sharded_stereo_pipeline

MESHES = [(1, 2, 4), (1, 1, 8), (2, 2, 2), (1, 4, 2), (1, 1, 1)]


def _synthetic_pair(h=96, w=320):
    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, size=(h, w + 32, 3), dtype=np.uint8)
    sm = base.astype(np.float32)
    sm = (sm + np.roll(sm, 1, 1) + np.roll(sm, -1, 1)) / 3
    base = sm.astype(np.uint8)
    return base[:, 16 : 16 + w][None], base[:, 10 : 10 + w][None]


@pytest.fixture(scope="module")
def tsukuba_oracle(tsukuba):
    left, right = tsukuba
    return left[None], right[None], R.run_pipeline(left, right, CFG)


@pytest.mark.parametrize("bshape", MESHES)
def test_sharded_matches_oracle_tsukuba(tsukuba_oracle, bshape):
    left, right, oracle = tsukuba_oracle
    b, ty, tx = bshape
    if b * ty * tx > len(jax.devices()):
        pytest.skip("not enough devices")
    l = np.concatenate([left] * b)
    r = np.concatenate([right] * b)
    mesh = make_mesh(b, ty, tx)
    out = sharded_stereo_pipeline(l, r, mesh, CFG)
    n = oracle["disparity_left"].size
    for key in ["disparity_left", "disparity_right", "occlusion", "occlusion_filled"]:
        mism = int((np.asarray(out[key][0]) != oracle[key]).sum())
        assert mism <= n * 2e-4, f"{key}: {mism}/{n} mismatches on mesh {bshape}"
    # fast-path grayscale may be +1 on a handful of exact-integer pixels
    # (3-4 per Tsukuba frame), which nudges the box mean by <=1
    mean = np.asarray(out["mean_left"][0]).astype(np.int32)
    want = oracle["mean_left"].astype(np.int32)
    d = np.abs(mean - want)
    assert d.max() <= 1 and (d != 0).sum() <= 64


def test_sharded_batch_frames_identical():
    left, right = _synthetic_pair()
    if len(jax.devices()) < 8:
        pytest.skip("not enough devices")
    l = np.concatenate([left, left])
    r = np.concatenate([right, right])
    mesh = make_mesh(2, 2, 2)
    out = sharded_stereo_pipeline(l, r, mesh, CFG)
    for key, v in out.items():
        a = np.asarray(v)
        np.testing.assert_array_equal(a[0], a[1], err_msg=key)


def test_sharded_single_device_equals_unsharded():
    left, right = _synthetic_pair()
    mesh = make_mesh(1, 1, 1)
    out = sharded_stereo_pipeline(left, right, mesh, CFG)
    from stereo_matching.pipeline import compute_disparity

    ref = compute_disparity(left[0], right[0], CFG)
    n = ref["disparity_left"].size
    for key in ["disparity_left", "disparity_right", "occlusion", "occlusion_filled"]:
        a = np.asarray(out[key][0])
        mism = int((a != ref[key]).sum())
        # same device count, but the tile pipeline masks/extends arrays
        # differently, so near-ties can still flip on noise frames
        assert mism <= n * 2e-3, f"{key}: {mism} mismatches 1-device-sharded vs unsharded"


def test_sharded_rejects_tile_smaller_than_halo():
    left, right = _synthetic_pair(h=96, w=128)
    if len(jax.devices()) < 8:
        pytest.skip("not enough devices")
    mesh = make_mesh(1, 1, 8)  # tile width 16 < halo 36
    with pytest.raises(ValueError, match="halo"):
        sharded_stereo_pipeline(left, right, mesh, CFG)


def test_pipeline_halo_values():
    hy, hx = pipeline_halo(CFG)
    assert hy == 2 * (CFG.radius + 1) == 20
    assert hx == 15 + 1 + 20  # max |d| + derivative + two box radii


@pytest.mark.parametrize("kw", [dict(d=8), dict(d=4, x=2), dict(d=2, y=2, x=2),
                                dict(b=2, d=2, x=2)])
def test_disparity_sharded_matches_oracle(tsukuba_oracle, kw):
    """The 'd' mesh axis shards the disparity range; per-range winners
    are combined with the ascending `best >= q` rule across chips."""
    left, right, oracle = tsukuba_oracle
    b = kw.get("b", 1)
    if b * kw.get("d", 1) * kw.get("y", 1) * kw.get("x", 1) > len(jax.devices()):
        pytest.skip("not enough devices")
    l = np.concatenate([left] * b)
    r = np.concatenate([right] * b)
    mesh = make_mesh(**kw)
    out = sharded_stereo_pipeline(l, r, mesh, CFG)
    n = oracle["disparity_left"].size
    for key in ["disparity_left", "disparity_right", "occlusion_filled"]:
        mism = int((np.asarray(out[key][0]) != oracle[key]).sum())
        assert mism <= n * 2e-4, f"{key}: {mism}/{n} on mesh {kw}"


def test_disparity_sharded_wide_range():
    """64 disparities sharded over 8 chips vs the unsharded jnp path."""
    import dataclasses

    if len(jax.devices()) < 8:
        pytest.skip("not enough devices")
    cfg64 = dataclasses.replace(CFG, d_min=-63, d_max=0)
    left, right = _synthetic_pair(h=64, w=320)
    mesh = make_mesh(d=8)
    out = sharded_stereo_pipeline(left, right, mesh, cfg64)
    from stereo_matching.pipeline import compute_disparity

    ref = compute_disparity(left[0], right[0], cfg64)
    n = ref["disparity_left"].size
    for key in ["disparity_left", "occlusion_filled"]:
        mism = int((np.asarray(out[key][0]) != ref[key]).sum())
        assert mism <= n * 2e-3, f"{key}: {mism}/{n}"


def test_multihost_single_process_path():
    """pod_mesh/from_host_batches degrade to device_put single-process."""
    from stereo_matching.parallel import from_host_batches, pod_mesh

    if len(jax.devices()) != 8:
        pytest.skip("expects 8 virtual devices")
    mesh = pod_mesh(frames_per_host=2, x=2, d=2)
    left, right = _synthetic_pair()
    l = np.concatenate([left, left])
    r = np.concatenate([right, right])
    gl, gr = from_host_batches(mesh, l, r)
    out = sharded_stereo_pipeline(gl, gr, mesh, CFG)
    a = np.asarray(out["occlusion_filled"])
    np.testing.assert_array_equal(a[0], a[1])
