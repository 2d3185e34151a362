"""PNM (PGM/PPM) and PFM codecs + the read_image dispatcher
(stb_image.h reads PNM; Middlebury GT disparities ship as PFM)."""

import numpy as np
import pytest

from stereo_matching.utils import pnm
from stereo_matching.utils.io import read_image


@pytest.mark.parametrize("shape,dtype", [
    ((13, 17), np.uint8), ((13, 17), np.uint16),
    ((9, 11, 3), np.uint8), ((9, 11, 3), np.uint16)])
def test_pnm_roundtrip(tmp_path, rng, shape, dtype):
    hi = 256 if dtype == np.uint8 else 65536
    img = rng.integers(0, hi, size=shape).astype(dtype)
    p = str(tmp_path / "img.pnm")
    pnm.write_pnm(p, img)
    back = pnm.read_pnm(p)
    assert back.dtype == dtype
    np.testing.assert_array_equal(back, img)
    np.testing.assert_array_equal(read_image(p), img)


def test_pnm_comments_and_whitespace(tmp_path):
    p = str(tmp_path / "c.pgm")
    with open(p, "wb") as f:
        f.write(b"P5 # a comment\n# another\n 3\t2 #x\n255\n" + bytes(range(6)))
    np.testing.assert_array_equal(
        pnm.read_pnm(p), np.arange(6, dtype=np.uint8).reshape(2, 3))


@pytest.mark.parametrize("shape", [(7, 9), (5, 6, 3)])
def test_pfm_roundtrip(tmp_path, rng, shape):
    arr = rng.normal(0, 60, size=shape).astype(np.float32)
    p = str(tmp_path / "d.pfm")
    pnm.write_pfm(p, arr)
    back = pnm.read_pfm(p)
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back, arr)
    np.testing.assert_array_equal(read_image(p), arr)


def test_pfm_big_endian_and_row_order(tmp_path):
    """Hand-built big-endian PFM: scale > 0, rows bottom-up."""
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    p = str(tmp_path / "be.pfm")
    with open(p, "wb") as f:
        f.write(b"Pf\n4 3\n1.0\n")
        f.write(arr[::-1].astype(">f4").tobytes())
    np.testing.assert_array_equal(pnm.read_pfm(p), arr)


def test_gt_workflow_pfm(tmp_path, rng):
    """--gt on a Middlebury-style PFM with inf = unknown."""
    import subprocess
    import sys
    import os
    import json

    from stereo_matching.utils.io import write_png

    rng2 = np.random.default_rng(5)
    base = rng2.integers(0, 256, (48, 64 + 8, 3), dtype=np.uint8)
    lp, rp = str(tmp_path / "l.png"), str(tmp_path / "r.png")
    write_png(lp, base[:, 8:])
    write_png(rp, base[:, :-8])
    gt = rng2.uniform(0, 15, (48, 64)).astype(np.float32)
    gt[0, :5] = np.inf  # unknown pixels
    gp = str(tmp_path / "gt.pfm")
    pnm.write_pfm(gp, gt)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_cpu_enable_fast_math=false"}
    p = subprocess.run(
        [sys.executable, "-m", "stereo_matching", lp, rp,
         "-o", str(tmp_path), "--gt", gp, "--json"],
        capture_output=True, text=True, env=env, timeout=300,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert p.returncode == 0, p.stderr
    stats = json.loads(p.stdout)
    assert "bad_2_0_pct" in stats and "epe" in stats
    assert np.isfinite(stats["bad_2_0_pct"]) and np.isfinite(stats["epe"])


def test_pfm_crlf_header(tmp_path):
    """CRLF-written PFM headers must not shift the payload by one byte
    (review r5)."""
    import numpy as np

    from stereo_matching.utils.pnm import read_pfm

    arr = np.arange(12, dtype="<f4").reshape(3, 4)
    p = tmp_path / "crlf.pfm"
    payload = arr[::-1].tobytes()                 # bottom-up rows
    p.write_bytes(b"Pf\r\n4 3\r\n-1.0\r\n" + payload)
    np.testing.assert_array_equal(read_pfm(str(p)), arr)
