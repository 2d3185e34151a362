"""True ground-truth accuracy on the committed synthetic-GT fixture.

The reference ships no ground truth (SURVEY.md §6: its data/ holds only
its own outputs), so BASELINE.json's bad-2.0 metric had nothing real to
score against.  tests/data/synthgt/scene0 is a rendered layered scene
(stereo_matching/utils/synth.py) whose integer disparity field
and occlusion set are exact by construction; these tests validate the
full --eval/--gt metric chain (sign convention, occlusion exclusion,
calib ndisp) against it and pin the accuracy of every production mode.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from stereo_matching.config import StereoConfig
from stereo_matching.metrics import bad_pixel_rate, end_point_error
from stereo_matching.utils.synth import make_scene

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "synthgt")
SCENE0 = os.path.join(FIXTURE, "scene0")


@pytest.fixture(scope="module")
def scene():
    return make_scene()


def test_generator_photometric_consistency(scene):
    """Non-occluded left pixels must equal right(x - d) EXACTLY — the
    two views sample the same texture array, so any mismatch is a
    renderer bug, not image noise."""
    gt = scene["gt"].astype(np.int32)
    h, w = gt.shape
    ys, xs = np.indices((h, w))
    vis = ~scene["occluded"]
    xr = xs - gt
    np.testing.assert_array_equal(
        scene["left"][ys[vis], xs[vis]],
        scene["right"][ys[vis], xr[vis]])


def test_generator_geometry(scene):
    """Occlusion set sanity: excluded pixels exist (the scene has real
    occluders), are a small minority, include the left border band, and
    every GT value is in [1, ndisp-1] (0 is reserved for 'excluded')."""
    occ = scene["occluded"]
    assert 0.01 < occ.mean() < 0.15
    gt_all = scene["gt_all"]
    border = int(gt_all[:, :1].max())
    assert occ[:, :border].all()
    vals = scene["gt"][~occ]
    assert vals.min() >= 1 and vals.max() <= scene["ndisp"] - 1


def test_fixture_matches_generator(scene):
    """The committed fixture is exactly make_scene() — guards against
    silent drift between the generator and the checked-in goldens."""
    from stereo_matching.utils.io import read_png
    from stereo_matching.utils.pnm import read_pfm

    np.testing.assert_array_equal(
        read_png(os.path.join(SCENE0, "im0.png")), scene["left"])
    np.testing.assert_array_equal(
        read_png(os.path.join(SCENE0, "im1.png")), scene["right"])
    np.testing.assert_array_equal(
        read_pfm(os.path.join(SCENE0, "disp0.pfm")), scene["gt"])


@pytest.mark.parametrize("mode", ["fast", "exact"])
def test_pipeline_accuracy_vs_true_gt(scene, mode):
    """bad-2.0 on non-occluded pixels must stay under 2% (measured
    ~0.57%) and EPE under 0.2 px (measured ~0.047) — real accuracy, not
    parity-vs-self."""
    from stereo_matching.pipeline import compute_disparity

    cfg = StereoConfig(exact_integral=(mode == "exact"))
    out = compute_disparity(scene["left"], scene["right"], cfg)
    disp = np.abs(np.asarray(out["occlusion_filled"], np.float32))
    bad2 = bad_pixel_rate(disp, scene["gt"], 2.0)
    epe = end_point_error(disp, scene["gt"])
    assert bad2 < 2.0, f"{mode}: bad-2.0 {bad2:.3f}%"
    assert epe < 0.2, f"{mode}: EPE {epe:.4f}"


def test_sharded_accuracy_vs_true_gt(scene):
    """The multi-chip path must hold the same true-GT accuracy class."""
    import jax

    from stereo_matching.parallel import (
        make_mesh, sharded_stereo_pipeline)

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_mesh(1, 2, 2, 2)
    out = sharded_stereo_pipeline(scene["left"][None], scene["right"][None],
                                  mesh, StereoConfig())
    disp = np.abs(np.asarray(out["occlusion_filled"][0], np.float32))
    assert bad_pixel_rate(disp, scene["gt"], 2.0) < 2.0
    assert end_point_error(disp, scene["gt"]) < 0.2


def test_occlusion_detection_vs_true_geometry(scene):
    """The LR-check's occlusion set vs the scene's geometric truth:
    require >70% recall of true occlusions and <10% false-positive rate
    (the classic LR check over-flags near boundaries; this bounds it)."""
    from stereo_matching.pipeline import compute_disparity

    out = compute_disparity(scene["left"], scene["right"], StereoConfig())
    cfg = StereoConfig()
    flagged = np.asarray(out["occlusion"]) < cfg.d_min
    true_occ = scene["occluded"]
    recall = (flagged & true_occ).sum() / true_occ.sum()
    fpr = (flagged & ~true_occ).sum() / (~true_occ).sum()
    assert recall > 0.7, f"occlusion recall {recall:.3f}"
    assert fpr < 0.10, f"occlusion false-positive rate {fpr:.3f}"


def test_cli_eval_on_fixture(tmp_path):
    """End-to-end: python -m ... --eval on the committed fixture reports
    the true-GT bad-2.0 through calib.txt's ndisp."""
    import json

    env = dict(os.environ)
    r = subprocess.run(
        [sys.executable, "-m", "stereo_matching",
         "--eval", FIXTURE, "--json"],
        capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    rep = json.loads(r.stdout)
    s0 = rep["scenes"]["scene0"]
    assert s0["ndisp"] == 16
    assert s0["bad_2_0_pct"] < 2.0
    assert rep["aggregate"]["scored"] == 2   # scene0 + scene1_wide


def test_eval_dataset_two_scenes_aggregate():
    """evaluate_dataset over the 2-scene fixture: the wide scene's
    calib.txt (ndisp=64) must override the search range per scene, and
    the aggregate must report both conventions over 2 scored scenes."""
    from stereo_matching.evaluate import evaluate_dataset

    rep = evaluate_dataset(FIXTURE, StereoConfig())
    agg = rep["aggregate"]
    assert agg["scenes"] == 2 and agg["scored"] == 2 and agg["errors"] == 0
    s0, s1 = rep["scenes"]["scene0"], rep["scenes"]["scene1_wide"]
    assert s0["ndisp"] == 16 and s1["ndisp"] == 64
    assert s0["bad_2_0_pct"] < 2.0
    assert s1["bad_2_0_pct"] < 5.0        # measured 2.34 (wider range,
    assert s1["epe"] < 1.5                 # 14% occlusion)
    assert "bad_2_0_pct_weighted" in agg and "epe_weighted" in agg
    lo, hi = sorted([s0["bad_2_0_pct"], s1["bad_2_0_pct"]])
    assert lo <= agg["bad_2_0_pct_mean"] <= hi


def test_eval_zero_valid_gt_not_scored(tmp_path):
    """A GT file with zero valid pixels must not score a fake perfect
    0.0 into the aggregate (review r5)."""
    import shutil

    from stereo_matching.evaluate import evaluate_dataset
    from stereo_matching.utils.pnm import write_pfm

    scene = tmp_path / "zero_gt"
    scene.mkdir()
    shutil.copy(f"{FIXTURE}/scene0/im0.png", scene / "im0.png")
    shutil.copy(f"{FIXTURE}/scene0/im1.png", scene / "im1.png")
    write_pfm(str(scene / "disp0.pfm"),
              np.full((240, 320), np.inf, np.float32))   # all-unknown GT
    rep = evaluate_dataset(str(tmp_path), StereoConfig())
    s = rep["scenes"]["zero_gt"]
    assert "bad_2_0_pct" not in s
    assert "gt_note" in s
    assert rep["aggregate"]["scored"] == 0


def test_eval_corrupt_scene_isolated(tmp_path):
    """A scene whose PNG is corrupt must be reported as {'error': ...}
    instead of aborting the dataset run — the pure-Python codec raises
    beyond (OSError, ValueError) on mangled headers (review r5)."""
    import shutil

    from stereo_matching.evaluate import evaluate_dataset

    good = tmp_path / "good"
    good.mkdir()
    for f in ("im0.png", "im1.png", "disp0.pfm", "calib.txt"):
        src = f"{FIXTURE}/scene0/{f}"
        if os.path.exists(src):
            shutil.copy(src, good / f)
    bad = tmp_path / "bad"
    bad.mkdir()
    shutil.copy(f"{FIXTURE}/scene0/im1.png", bad / "im1.png")
    raw = bytearray(open(f"{FIXTURE}/scene0/im0.png", "rb").read())
    raw[25] = 99   # mangle the IHDR color-type byte
    (bad / "im0.png").write_bytes(bytes(raw))
    rep = evaluate_dataset(str(tmp_path), StereoConfig())
    assert "error" in rep["scenes"]["bad"]
    assert "bad_2_0_pct" in rep["scenes"]["good"]
    assert rep["aggregate"]["errors"] == 1
