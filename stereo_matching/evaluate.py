"""Dataset evaluation harness (Middlebury-2014 directory layout).

The reference has no quantitative evaluation at all — its only outputs
are eyeball-diff PNGs (main.cu:162-181).  The BASELINE.json north star
asks for bad-2.0 on Tsukuba/Middlebury, so this module walks a dataset
directory of scenes:

    dataset/
      SceneA/ im0.png  im1.png  disp0.pfm  [calib.txt]
      SceneB/ ...

runs the pipeline per scene, and scores the |filled disparity| against
the ground truth (PFM, Middlebury convention: float disparities,
inf = unknown; or a 16-bit PNG with a scale factor).

The disparity search range comes from calib.txt's ``ndisp`` when
present (Middlebury publishes it per scene), else from the config.
Middlebury disparities are positive left-shifts; the pipeline's left
labels are ``d_min..0`` negatives (SURVEY.md §2.5.7), so ndisp=N maps
to d_min = -(N-1), d_max = 0 and metrics use |d|.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator

import numpy as np

from .config import StereoConfig
from .metrics import bad_pixel_rate, end_point_error
from .utils.io import read_image


def _read_calib_ndisp(path: str) -> int | None:
    """Parse ``ndisp=N`` from a Middlebury calib.txt."""
    try:
        with open(path) as f:
            for line in f:
                if line.startswith("ndisp="):
                    return int(float(line.split("=", 1)[1]))
    except OSError:
        return None
    return None


def find_scenes(root: str) -> Iterator[tuple[str, str]]:
    """Yield (scene_name, scene_dir) for every subdirectory of ``root``
    holding an im0/im1 pair; ``root`` itself counts if it holds one."""
    def has_pair(d):
        return (os.path.isfile(os.path.join(d, "im0.png"))
                and os.path.isfile(os.path.join(d, "im1.png")))

    if has_pair(root):
        yield os.path.basename(os.path.abspath(root)) or root, root
        return
    for name in sorted(os.listdir(root)):
        d = os.path.join(root, name)
        if os.path.isdir(d) and has_pair(d):
            yield name, d


def load_gt(scene_dir: str, gt_scale: float = 1.0) -> np.ndarray | None:
    """Ground-truth |disparity| map, 0 where unknown, or None."""
    for cand, scale in (("disp0.pfm", 1.0), ("disp0GT.pfm", 1.0),
                        ("disp0.png", gt_scale), ("disp2.png", gt_scale)):
        p = os.path.join(scene_dir, cand)
        if os.path.isfile(p):
            g = read_image(p).astype(np.float32)
            if g.ndim == 3:
                g = g[..., 0]
            g = np.where(np.isfinite(g), g, np.float32(0))
            return g / np.float32(scale if scale else 1.0)
    return None


def evaluate_scene(scene_dir: str, cfg: StereoConfig,
                   gt_scale: float = 1.0) -> dict:
    """Run the pipeline on one scene and score it.  Returns a stats
    dict; ``bad_2_0_pct``/``epe`` are present only when GT exists."""
    from .pipeline import compute_disparity

    left = read_image(os.path.join(scene_dir, "im0.png"))
    right = read_image(os.path.join(scene_dir, "im1.png"))
    if left.ndim != 3 or left.shape != right.shape:
        raise ValueError(
            f"{scene_dir}: need same-shaped color pairs, got "
            f"{left.shape} vs {right.shape}")
    if left.dtype != np.uint8 or right.dtype != np.uint8:
        raise ValueError(
            f"{scene_dir}: images must be 8-bit, got "
            f"{left.dtype}/{right.dtype}")

    # load + shape-check GT BEFORE the pipeline run: a mismatched GT
    # would otherwise waste the full compile+run
    gt = load_gt(scene_dir, gt_scale)
    if gt is not None and gt.shape != left.shape[:2]:
        raise ValueError(
            f"{scene_dir}: GT shape {gt.shape} != image {left.shape[:2]}")

    ndisp = _read_calib_ndisp(os.path.join(scene_dir, "calib.txt"))
    if ndisp is not None:
        # per-scene range override: drop user knobs the new range makes
        # invalid instead of aborting the whole dataset run
        over: dict = {"d_min": -(ndisp - 1), "d_max": 0}
        if cfg.d_chunk is not None and ndisp % cfg.d_chunk:
            over["d_chunk"] = None
        cfg = dataclasses.replace(cfg, **over)

    out = compute_disparity(left, right, cfg)
    disp = np.abs(np.asarray(out["occlusion_filled"], np.float32))
    stats = {
        "height": int(left.shape[0]), "width": int(left.shape[1]),
        "ndisp": cfg.size_d,
    }
    if gt is not None and not (gt != 0).any():
        # a GT file with zero valid pixels must not score a fake
        # perfect 0.0 into the aggregate (review r5)
        stats["gt_note"] = "GT present but no valid pixels; not scored"
        gt = None
    if gt is not None:
        stats["bad_2_0_pct"] = round(bad_pixel_rate(disp, gt, 2.0), 3)
        stats["bad_1_0_pct"] = round(bad_pixel_rate(disp, gt, 1.0), 3)
        stats["epe"] = round(end_point_error(disp, gt), 3)
        stats["gt_valid_px"] = int((gt != 0).sum())
        stats["gt_coverage_pct"] = round(100.0 * float((gt != 0).mean()), 1)
    return stats


def evaluate_dataset(root: str, cfg: StereoConfig,
                     gt_scale: float = 1.0) -> dict:
    """Evaluate every scene under ``root``.  A scene that fails (bad
    files, incompatible config) is reported as {"error": ...} instead
    of aborting the run.  Aggregate reports BOTH conventions: the plain
    per-scene mean (Middlebury's "dense" average) and the
    GT-valid-pixel-weighted mean."""
    scenes = {}
    for name, d in find_scenes(root):
        try:
            scenes[name] = evaluate_scene(d, cfg, gt_scale)
        except Exception as e:   # any per-scene failure isolates: the
            # codecs can raise beyond (OSError, ValueError) — e.g. the
            # pure-Python PNG fallback raises KeyError/struct.error on
            # corrupt headers (review r5)
            scenes[name] = {"error": f"{type(e).__name__}: {e}"}
    if not scenes:
        raise ValueError(f"no scenes with im0.png/im1.png under {root}")
    scored = [s for s in scenes.values() if "bad_2_0_pct" in s]
    agg: dict = {"scenes": len(scenes), "scored": len(scored),
                 "errors": sum(1 for s in scenes.values() if "error" in s)}
    if scored:
        agg["bad_2_0_pct_mean"] = round(
            float(np.mean([s["bad_2_0_pct"] for s in scored])), 3)
        agg["bad_1_0_pct_mean"] = round(
            float(np.mean([s["bad_1_0_pct"] for s in scored])), 3)
        agg["epe_mean"] = round(
            float(np.mean([s["epe"] for s in scored])), 3)
        w = np.array([s["gt_valid_px"] for s in scored], np.float64)
        if w.sum() > 0:
            agg["bad_2_0_pct_weighted"] = round(float(np.average(
                [s["bad_2_0_pct"] for s in scored], weights=w)), 3)
            agg["bad_1_0_pct_weighted"] = round(float(np.average(
                [s["bad_1_0_pct"] for s in scored], weights=w)), 3)
            agg["epe_weighted"] = round(float(np.average(
                [s["epe"] for s in scored], weights=w)), 3)
    return {"scenes": scenes, "aggregate": agg}
