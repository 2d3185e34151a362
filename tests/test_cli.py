"""CLI surface tests (subprocess, the real user interface)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from stereo_matching.utils.io import write_png

ENV = {
    **os.environ,
    "JAX_PLATFORMS": "cpu",
    "XLA_FLAGS": "--xla_force_host_platform_device_count=8 "
                 "--xla_cpu_enable_fast_math=false",
}


def _write_pair(tmp_path):
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (64, 96 + 16, 3), dtype=np.uint8)
    lp, rp = str(tmp_path / "l.png"), str(tmp_path / "r.png")
    write_png(lp, base[:, 8 : 8 + 96])
    write_png(rp, base[:, 4 : 4 + 96])
    return lp, rp


def _run(args):
    return subprocess.run(
        [sys.executable, "-m", "stereo_matching", *args],
        capture_output=True, text=True, env=ENV, timeout=300,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )


def test_cli_basic_json(tmp_path):
    lp, rp = _write_pair(tmp_path)
    r = _run([lp, rp, "-o", str(tmp_path / "out"), "--json"])
    assert r.returncode == 0, r.stderr
    stats = json.loads(r.stdout.strip().splitlines()[-1])
    assert stats["disparities"] == 16
    assert (tmp_path / "out" / "disparity_mapl.png").exists()
    assert (tmp_path / "out" / "occlu_mapl_filled.png").exists()


def test_cli_mismatched_sizes_exit2(tmp_path):
    lp, rp = _write_pair(tmp_path)
    crop = str(tmp_path / "crop.png")
    from stereo_matching.utils.io import read_png

    write_png(crop, read_png(lp)[:32, :32])
    r = _run([crop, rp, "-o", str(tmp_path / "out")])
    assert r.returncode == 2
    assert "shapes differ" in r.stderr


def test_cli_mesh_mode(tmp_path):
    lp, rp = _write_pair(tmp_path)
    r = _run([lp, rp, "-o", str(tmp_path / "out"), "--mesh", "1,1,2,2", "--json"])
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "out" / "disparity_mapl.png").exists()


def test_cli_flag_combinations_exit2(tmp_path):
    """Invalid combinations must print a clean error, not a traceback."""
    lp, rp = _write_pair(tmp_path)
    for extra in (["--mesh", "1,1,2", "--exact"],
                  ["--mesh", "1,1,2", "--aggregation", "box"],
                  ["--oracle", "--aggregation", "box"]):
        p = _run([lp, rp, "-o", str(tmp_path)] + extra)
        assert p.returncode == 2, (extra, p.stderr)
        assert "error:" in p.stderr and "Traceback" not in p.stderr, p.stderr


def test_cli_eval_dataset(tmp_path):
    """--eval over a tiny Middlebury-layout dataset: GT produced by the
    oracle itself, so bad-2.0 must be ~0 and calib ndisp must be used."""
    from stereo_matching import reference as R
    from stereo_matching.config import StereoConfig
    from stereo_matching.utils.pnm import write_pfm

    rng = np.random.default_rng(7)
    base = rng.integers(0, 256, (48, 80 + 16, 3), dtype=np.uint8)
    left, right = base[:, 8 : 8 + 80], base[:, 4 : 4 + 80]
    cfg = StereoConfig(d_min=-7, d_max=0)
    out = R.run_pipeline(left, right, cfg)
    gt = np.abs(out["occlusion_filled"].astype(np.float32))

    for scene in ("SceneA", "SceneB"):
        d = tmp_path / "ds" / scene
        d.mkdir(parents=True)
        write_png(str(d / "im0.png"), left)
        write_png(str(d / "im1.png"), right)
        write_pfm(str(d / "disp0.pfm"), gt)
        (d / "calib.txt").write_text("cam0=[1 0 0]\nndisp=8\n")

    r = _run([str(tmp_path / "ds"), "--eval"])
    assert r.returncode == 0, r.stderr
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["aggregate"]["scenes"] == 2
    assert result["aggregate"]["scored"] == 2
    for s in result["scenes"].values():
        assert s["ndisp"] == 8          # from calib.txt, not the default 16
        assert s["bad_2_0_pct"] <= 0.5  # fast path: near-ties only
        assert s["epe"] <= 0.1


def test_cli_eval_missing_right_pair_required(tmp_path):
    lp, _ = _write_pair(tmp_path)
    r = _run([lp])
    assert r.returncode == 2
    assert "right image is required" in r.stderr


def test_sequence_rejects_unsupported_combos(tmp_path):
    """--sequence previously IGNORED --oracle/--mesh/--gt (review r5);
    now it must reject them with exit 2."""
    from stereo_matching.cli import main

    (tmp_path / "L").mkdir()
    (tmp_path / "R").mkdir()
    rc = main([str(tmp_path / "L"), str(tmp_path / "R"),
               "--sequence", "--oracle"])
    assert rc == 2


def test_eval_rejects_box_aggregation(tmp_path):
    from stereo_matching.cli import main

    rc = main([str(tmp_path), "--eval", "--aggregation", "box"])
    assert rc == 2
