"""Baseline JPEG decoder (utils/jpeg.py) vs PIL/libjpeg-turbo as the
independent reference decoder (PIL is test-only; the product decoder
is self-contained).  The JPEG spec does not mandate a bitwise IDCT, so
tolerances are ±3 with tight fraction bounds (measured: mean ≤ 0.4)."""

import os

import numpy as np
import pytest

PIL = pytest.importorskip("PIL.Image")

from stereo_matching.utils.jpeg import read_jpeg
from stereo_matching.utils.io import read_image


def _scene(h=97, w=133, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w, 3)).astype(np.float32)
    for _ in range(3):
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)
                + np.roll(base, -1, 1)) / 4
    return base.astype(np.uint8)


def _roundtrip(tmp_path, arr, **save_kw):
    p = str(tmp_path / "x.jpg")
    PIL.fromarray(arr).save(p, "JPEG", **save_kw)
    got = read_jpeg(p)
    want = np.asarray(
        PIL.open(p).convert("L" if arr.ndim == 2 else "RGB"), np.int32)
    return got, want


@pytest.mark.parametrize("kw", [
    dict(quality=90),                                  # gray path below
    dict(quality=85, subsampling=2),                   # 4:2:0
    dict(quality=90, subsampling=1),                   # 4:2:2
    dict(quality=95, subsampling=0),                   # 4:4:4
    dict(quality=75, subsampling=0, restart_marker_rows=2),  # RSTn
])
def test_jpeg_matches_pil(tmp_path, kw):
    img = _scene()
    got, want = _roundtrip(tmp_path, img, **kw)
    assert got.shape == want.shape and got.dtype == np.uint8
    d = np.abs(got.astype(np.int32) - want)
    assert d.max() <= 3, d.max()
    assert (d > 1).mean() <= 0.15
    assert d.mean() <= 0.6


def test_jpeg_grayscale(tmp_path):
    gray = _scene()[..., 0]
    got, want = _roundtrip(tmp_path, gray, quality=90)
    assert got.ndim == 2
    d = np.abs(got.astype(np.int32) - want)
    assert d.max() <= 1       # no chroma: float-vs-islow IDCT only


def test_jpeg_odd_sizes(tmp_path):
    """Dimensions not multiples of the MCU size exercise the partial
    edge blocks."""
    img = _scene(41, 59, seed=3)
    got, want = _roundtrip(tmp_path, img, quality=85, subsampling=2)
    assert got.shape == (41, 59, 3)
    assert np.abs(got.astype(np.int32) - want).max() <= 3


def test_jpeg_via_read_image(tmp_path):
    """read_image dispatches on the FFD8 magic."""
    img = _scene(32, 48, seed=5)
    p = str(tmp_path / "m.jpg")
    PIL.fromarray(img).save(p, "JPEG", quality=92)
    np.testing.assert_array_equal(read_image(p), read_jpeg(p))


@pytest.mark.parametrize("kw", [
    dict(quality=90, subsampling=2),                   # 4:2:0
    dict(quality=95, subsampling=0),                   # 4:4:4
])
def test_jpeg_progressive_matches_pil(tmp_path, kw):
    """Progressive (SOF2) color decode vs PIL: PIL's default
    progression script uses successive approximation, so this
    exercises DC first/refine and AC first/refine incl. EOB runs."""
    img = _scene()
    got, want = _roundtrip(tmp_path, img, progressive=True, **kw)
    assert got.shape == want.shape and got.dtype == np.uint8
    d = np.abs(got.astype(np.int32) - want)
    assert d.max() <= 3, d.max()
    assert (d > 1).mean() <= 0.15
    assert d.mean() <= 0.6


def test_jpeg_progressive_grayscale(tmp_path):
    gray = _scene()[..., 0]
    got, want = _roundtrip(tmp_path, gray, quality=90, progressive=True)
    assert got.ndim == 2
    d = np.abs(got.astype(np.int32) - want)
    assert d.max() <= 1


def test_jpeg_progressive_odd_sizes(tmp_path):
    """Non-MCU-multiple dims: non-interleaved AC scans walk the
    component's REAL block grid (smaller than the MCU-padded one)."""
    img = _scene(41, 59, seed=3)
    got, want = _roundtrip(tmp_path, img, quality=85, subsampling=2,
                           progressive=True)
    assert got.shape == (41, 59, 3)
    assert np.abs(got.astype(np.int32) - want).max() <= 3


def test_jpeg_progressive_identical_to_baseline_content(tmp_path):
    """The same pixels encoded baseline and progressive with the same
    quality/subsampling must decode to (near-)identical images — the
    two entropy layouts carry the same coefficients."""
    img = _scene(48, 64, seed=9)
    pb = str(tmp_path / "b.jpg")
    pp = str(tmp_path / "p.jpg")
    PIL.fromarray(img).save(pb, "JPEG", quality=90, subsampling=0)
    PIL.fromarray(img).save(pp, "JPEG", quality=90, subsampling=0,
                            progressive=True)
    db = read_jpeg(pb).astype(np.int32)
    dp = read_jpeg(pp).astype(np.int32)
    assert np.abs(db - dp).max() <= 1


def test_jpeg_truncated_rejected(tmp_path):
    img = _scene(32, 48, seed=5)
    p = str(tmp_path / "t.jpg")
    PIL.fromarray(img).save(p, "JPEG", quality=92)
    blob = open(p, "rb").read()
    with open(p, "wb") as f:
        f.write(blob[: len(blob) // 2])
    with pytest.raises(ValueError):
        read_jpeg(p)


def test_jpeg_not_a_jpeg(tmp_path):
    p = str(tmp_path / "n.jpg")
    with open(p, "wb") as f:
        f.write(b"hello world, definitely not a jpeg")
    with pytest.raises(ValueError, match="SOI"):
        read_jpeg(p)


def test_jpeg_pair_through_cli(tmp_path):
    """End-to-end: a JPEG stereo pair through the CLI (lossy input, so
    just assert the pipeline runs and emits sane outputs)."""
    import subprocess
    import sys

    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, (40, 72 + 8, 3), dtype=np.uint8)
    left, right = base[:, 8:], base[:, :-8]
    PIL.fromarray(left).save(str(tmp_path / "l.jpg"), "JPEG", quality=95)
    PIL.fromarray(right).save(str(tmp_path / "r.jpg"), "JPEG", quality=95)
    env = dict(os.environ)
    r = subprocess.run(
        [sys.executable, "-m", "stereo_matching",
         str(tmp_path / "l.jpg"), str(tmp_path / "r.jpg"),
         "-o", str(tmp_path), "--json"],
        capture_output=True, text=True, env=env)
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "disparity_mapl.png").exists()
