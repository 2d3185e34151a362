"""CLI driver — the reference's main() (main.cu:37-214), done right.

The reference ignores argv and hardcodes ./data/tsukuba{0,1}.png
(main.cu:57-58); every tunable is a compile-time #define.  Here every
constant is a flag (defaults = reference values), and the 12 output
PNGs of the reference are reproduced under --dump-intermediates.

Usage:
  python -m stereo_matching left.png right.png -o outdir/
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from .config import StereoConfig
from . import reference as R
from .utils.io import read_image, write_png


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="stereo_matching",
        description="Cost-volume stereo with guided-filter aggregation",
    )
    p.add_argument("left", nargs="?", default=None,
                   help="left image (PNG); dataset root with --eval; "
                        "omitted with --serve")
    p.add_argument("right", nargs="?", default=None,
                   help="right image (PNG); omitted with --eval/--serve")
    p.add_argument("-o", "--out", default=".", help="output directory")
    p.add_argument("--d-min", type=int, default=-15, help="min disparity (SystemIncludes.h:12)")
    p.add_argument("--d-max", type=int, default=0, help="max disparity (SystemIncludes.h:11)")
    p.add_argument("--alpha", type=float, default=0.9, help="gradient/color blend (SystemIncludes.h:10)")
    p.add_argument("--th-color", type=float, default=7.0, help="color truncation (SystemIncludes.h:14)")
    p.add_argument("--th-grad", type=float, default=2.0, help="gradient truncation (SystemIncludes.h:13)")
    p.add_argument("--radius", type=int, default=9, help="box filter radius (SystemIncludes.h:21)")
    p.add_argument("--eps", type=float, default=6.5025, help="guided filter eps (SystemIncludes.h:23)")
    p.add_argument("--d-lr", type=int, default=0, help="LR check tolerance (SystemIncludes.h:24)")
    p.add_argument("--d-chunk", type=int, default=None,
                   help="disparity slices per scan step (bounds peak HBM)")
    p.add_argument("--exact", action="store_true",
                   help="bit-exact parity mode (sequential integral images)")
    p.add_argument("--oracle", action="store_true",
                   help="run the NumPy golden oracle instead of the JAX pipeline")
    p.add_argument("--dump-intermediates", action="store_true",
                   help="write the reference's 12 debug PNGs (main.cu:162-181)")
    p.add_argument("--json", action="store_true", help="print timing/stats as one JSON line")
    p.add_argument("--gt", default=None,
                   help="ground-truth disparity PNG; adds bad-2.0 / EPE metrics")
    p.add_argument("--gt-scale", type=float, default=1.0,
                   help="GT PNG values are scale*|disparity| (e.g. 16 for Tsukuba GT)")
    p.add_argument("--profile", action="store_true",
                   help="print a per-stage device-time table (SURVEY.md §6 shape)")
    p.add_argument("--aggregation", choices=["guided", "box"], default="guided",
                   help="cost aggregation family: guided filter (reference "
                        "semantics) or plain box mean (SAD+box baseline)")
    p.add_argument("--mesh", default=None, metavar="B,Y,X[,D]",
                   help="run multi-chip: mesh sizes over (batch, tile-rows, "
                        "tile-cols, disparity-ranges), e.g. 1,2,4 or 1,2,2,2")
    p.add_argument("--eval", action="store_true",
                   help="LEFT is a dataset root (Middlebury layout: scene "
                        "dirs with im0.png/im1.png, disp0.pfm GT, calib.txt "
                        "ndisp); prints per-scene and aggregate bad-2.0/EPE")
    p.add_argument("--sequence", action="store_true",
                   help="left/right are DIRECTORIES of same-shaped frames; "
                        "pairs are matched by sorted filename order and "
                        "processed with one compiled executable")
    p.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="run a long-lived HTTP serving process (POST "
                        "/disparity with base64 image pairs, GET /healthz); "
                        "jit executables compile once per process and stay "
                        "warm")
    p.add_argument("--serve-host", default="127.0.0.1",
                   help="bind address for --serve (default 127.0.0.1)")
    p.add_argument("--serve-warmup", default=None, metavar="HxW",
                   help="compile the serving executable for HxW frames at "
                        "startup (e.g. 288x384) so the first request does "
                        "not pay the jit compile")
    p.add_argument("--serve-batch", type=int, default=8, metavar="N",
                   help="max micro-batch for --serve: concurrent same-shape "
                        "requests coalesce into one batched device pass "
                        "(padded to power-of-two sizes to bound the compile "
                        "set; non-power-of-two values round DOWN so padding "
                        "never exceeds the cap).  1 disables batching "
                        "(default 8)")
    p.add_argument("--serve-ranges", default=None, metavar="MIN:MAX[,...]",
                   help="allowlist of per-request d_min:d_max overrides for "
                        "--serve (e.g. '-15:0,-63:0'); others get 403 "
                        "instead of a minutes-long in-request jit compile. "
                        "Default: any range allowed")
    return p


def _normalize(mat: np.ndarray) -> np.ndarray:
    # utils.io routes through the native codec when built and the
    # NumPy oracle otherwise — one normalizer for CLI and serve
    from .utils.io import write_mat_normalize

    return write_mat_normalize(np.asarray(mat, dtype=np.float32))


def _run_sequence(args, cfg) -> int:
    """Directory mode: stream pairs through one compiled pipeline
    (guided by default; --aggregation box uses the box model)."""
    import glob

    if args.aggregation == "box":
        from .models.box import box_stereo_pipeline

        def compute(l, r, c):
            return {k: np.asarray(v)
                    for k, v in box_stereo_pipeline(l, r, c).items()}
    else:
        from .pipeline import compute_disparity as compute

    lefts = sorted(glob.glob(os.path.join(args.left, "*")))
    rights = sorted(glob.glob(os.path.join(args.right, "*")))
    if len(lefts) != len(rights) or not lefts:
        print(f"error: need equal nonempty frame lists, got {len(lefts)} vs "
              f"{len(rights)}", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    n = 0
    for lp, rp in zip(lefts, rights):
        try:
            left = read_image(lp)
            right = read_image(rp)
        except (OSError, ValueError, NotImplementedError) as e:
            print(f"error: {lp}/{rp}: {e}", file=sys.stderr)
            return 2
        if left.ndim != 3 or left.shape != right.shape or left.shape[2] < 3:
            print(f"error: {lp}/{rp}: need same-shaped color frames, got "
                  f"{left.shape} vs {right.shape}", file=sys.stderr)
            return 2
        if left.dtype != np.uint8 or right.dtype != np.uint8:
            print(f"error: {lp}/{rp}: frames must be 8-bit, got "
                  f"{left.dtype}/{right.dtype}", file=sys.stderr)
            return 2
        out = compute(left, right, cfg)
        stem = os.path.splitext(os.path.basename(lp))[0]
        write_png(os.path.join(args.out, f"{stem}_disparity.png"),
                  _normalize(out["occlusion_filled"]))
        n += 1
    dt = time.perf_counter() - t0
    stats = {"frames": n, "seconds": round(dt, 3),
             "fps": round(n / dt, 2) if dt else None}
    print(json.dumps(stats) if args.json else
          f"{n} frames in {dt:.2f} s ({stats['fps']} fps incl. PNG I/O)")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        cfg = StereoConfig(
            d_min=args.d_min, d_max=args.d_max, alpha=args.alpha,
            th_color=args.th_color, th_grad=args.th_grad, radius=args.radius,
            eps=args.eps, d_lr=args.d_lr, d_chunk=args.d_chunk,
            exact_integral=args.exact,
        )
    except ValueError as e:   # config validation (config.py __post_init__)
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.mesh and args.exact:
        print("error: --mesh does not support --exact (the sharded pipeline "
              "uses per-tile integral origins; run the parity mode on one "
              "chip)", file=sys.stderr)
        return 2
    if args.mesh and args.aggregation != "guided":
        print(f"error: --mesh only supports --aggregation guided, got "
              f"{args.aggregation!r}", file=sys.stderr)
        return 2
    if args.oracle and args.aggregation != "guided":
        print("error: --oracle implements the reference (guided) pipeline "
              "only; drop --aggregation box or --oracle", file=sys.stderr)
        return 2
    if not args.oracle:
        from .compile_cache import enable_compile_cache

        enable_compile_cache()
    if args.serve is not None:
        for flag, on in [("--eval", args.eval), ("--sequence", args.sequence),
                         ("--oracle", args.oracle), ("--mesh", args.mesh),
                         ("positional image arguments", args.left)]:
            if on:
                print(f"error: --serve does not combine with {flag}",
                      file=sys.stderr)
                return 2
        from .serve import serve_forever

        ranges = None
        if args.serve_ranges:
            try:
                ranges = [tuple(int(v) for v in part.split(":"))
                          for part in args.serve_ranges.split(",")]
                if any(len(r) != 2 for r in ranges):
                    raise ValueError
            except ValueError:
                print(f"error: bad --serve-ranges {args.serve_ranges!r} "
                      "(want MIN:MAX[,MIN:MAX...])", file=sys.stderr)
                return 2
            # the configured range is always servable
            ranges.append((cfg.d_min, cfg.d_max))
        warmup_hw = None
        if args.serve_warmup:
            try:
                warmup_hw = tuple(int(v) for v in args.serve_warmup.split("x"))
                if len(warmup_hw) != 2 or any(v <= 0 for v in warmup_hw):
                    raise ValueError
            except ValueError:
                print(f"error: bad --serve-warmup {args.serve_warmup!r} "
                      "(want HxW, e.g. 288x384)", file=sys.stderr)
                return 2
        if args.serve_batch < 1:
            print(f"error: --serve-batch must be >= 1, got "
                  f"{args.serve_batch}", file=sys.stderr)
            return 2
        serve_forever(args.serve_host, args.serve, cfg, ranges, warmup_hw,
                      max_batch=args.serve_batch)
        return 0
    if args.left is None:
        print("error: left image is required (or use --eval/--serve)",
              file=sys.stderr)
        return 2
    if args.eval:
        from .evaluate import evaluate_dataset

        if args.right is not None:
            print("error: --eval takes a single dataset root, not a pair",
                  file=sys.stderr)
            return 2
        for flag, on in [("--mesh", args.mesh), ("--sequence", args.sequence),
                         ("--oracle", args.oracle),
                         ("--aggregation box", args.aggregation == "box"),
                         ("--profile", args.profile)]:
            if on:
                print(f"error: --eval does not support {flag}",
                      file=sys.stderr)
                return 2
        try:
            result = evaluate_dataset(args.left, cfg, args.gt_scale)
        except (OSError, ValueError, NotImplementedError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        print(json.dumps(result))
        return 0
    if args.right is None:
        print("error: right image is required (or use --eval)",
              file=sys.stderr)
        return 2
    if args.sequence:
        # the sequence runner drives the batched JAX pipeline only —
        # reject modes it would silently ignore (review r5)
        for flag, on in [("--oracle", args.oracle), ("--mesh", args.mesh),
                         ("--gt", args.gt), ("--profile", args.profile),
                         ("--dump-intermediates", args.dump_intermediates)]:
            if on:
                print(f"error: --sequence does not support {flag}",
                      file=sys.stderr)
                return 2
        return _run_sequence(args, cfg)
    try:
        left = read_image(args.left)
        right = read_image(args.right)
    except (OSError, ValueError, NotImplementedError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if left.ndim != 3 or right.ndim != 3 or left.shape[2] < 3 or right.shape[2] < 3:
        print("error: inputs must be color images (H,W,3) or (H,W,4)", file=sys.stderr)
        return 2
    if left.dtype != np.uint8 or right.dtype != np.uint8:
        # 16-bit decode exists for --gt files; the matching pipeline's
        # contract (thresholds, grayscale truncation) is 8-bit
        print(f"error: input images must be 8-bit (got {left.dtype}/"
              f"{right.dtype}; 16-bit PNGs are supported only for --gt)",
              file=sys.stderr)
        return 2
    if left.shape != right.shape:
        print(f"error: image shapes differ: {left.shape} vs {right.shape}", file=sys.stderr)
        return 2

    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    if args.oracle:
        out = R.run_pipeline(left, right, cfg)
        out["cost_left_s0"] = out["cost_left"][0]
        out["cost_right_s0"] = out["cost_right"][0]
    elif args.mesh:
        import numpy as _np

        from .parallel import make_mesh, sharded_stereo_pipeline

        sizes = [int(x) for x in args.mesh.split(",")]
        if len(sizes) == 3:
            sizes.append(1)
        if len(sizes) != 4:
            print("error: --mesh wants B,Y,X or B,Y,X,D", file=sys.stderr)
            return 2
        b, y, x, d = sizes
        try:
            mesh = make_mesh(b, y, x, d)
        except ValueError as e:   # e.g. fewer devices than b*y*x*d
            print(f"error: {e}", file=sys.stderr)
            return 2
        sh_out = sharded_stereo_pipeline(
            _np.broadcast_to(left, (b,) + left.shape), 
            _np.broadcast_to(right, (b,) + right.shape), mesh, cfg)
        out = {k: _np.asarray(v[0]) for k, v in sh_out.items()}
    elif args.aggregation == "box":
        from .models.box import box_stereo_pipeline

        out = {k: np.asarray(v)
               for k, v in box_stereo_pipeline(left, right, cfg).items()}
    else:
        from .pipeline import compute_disparity

        out = compute_disparity(left, right, cfg, full_outputs=args.dump_intermediates)
    dt = time.perf_counter() - t0

    write_png(os.path.join(args.out, "disparity_mapl.png"), _normalize(out["disparity_left"]))
    write_png(os.path.join(args.out, "disparity_mapr.png"), _normalize(out["disparity_right"]))
    write_png(os.path.join(args.out, "occlu_mapl.png"), _normalize(out["occlusion"]))
    write_png(os.path.join(args.out, "occlu_mapl_filled.png"), _normalize(out["occlusion_filled"]))
    if args.dump_intermediates and "gray_left" not in out:
        print("note: --dump-intermediates intermediates are unavailable on "
              "this path (--mesh returns final maps only; --aggregation box "
              "has no guided-filter intermediates)", file=sys.stderr)
    if args.dump_intermediates and "gray_left" in out:
        write_png(os.path.join(args.out, "image_left.png"), np.asarray(out["gray_left"]))
        write_png(os.path.join(args.out, "image_right.png"), np.asarray(out["gray_right"]))
        write_png(os.path.join(args.out, "image_mean_left.png"), np.asarray(out["mean_left"]))
        write_png(os.path.join(args.out, "image_mean_right.png"), np.asarray(out["mean_right"]))
        write_png(os.path.join(args.out, "best_costl.png"), _normalize(out["best_cost_left"]))
        write_png(os.path.join(args.out, "best_costr.png"), _normalize(out["best_cost_right"]))
        write_png(os.path.join(args.out, "cost_lminus15.png"), _normalize(out["cost_left_s0"]))
        write_png(os.path.join(args.out, "cost_rminus15.png"), _normalize(out["cost_right_s0"]))

    occl = np.asarray(out["occlusion"])
    n_occl = int((occl.astype(np.int32) < cfg.v_min).sum())
    stats = {
        "height": int(left.shape[0]), "width": int(left.shape[1]),
        "disparities": cfg.size_d, "seconds": round(dt, 4),
        "occluded_pixels": n_occl,
        "occluded_pct": round(100.0 * n_occl / occl.size, 2),
        "backend": "oracle" if args.oracle else "jax",
    }
    if args.gt:
        from .metrics import bad_pixel_rate, end_point_error

        try:
            gt_img = read_image(args.gt).astype(np.float32)
        except (OSError, ValueError, NotImplementedError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if gt_img.ndim == 3:
            gt_img = gt_img[..., 0]
        # Middlebury PFM marks unknown pixels with inf; map them to the
        # metrics' gt_invalid value (0) so they are excluded
        gt_img = np.where(np.isfinite(gt_img), gt_img, np.float32(0))
        gt = gt_img / np.float32(args.gt_scale)
        disp = np.abs(np.asarray(out["occlusion_filled"], dtype=np.float32))
        stats["bad_2_0_pct"] = round(bad_pixel_rate(disp, gt, 2.0), 3)
        stats["epe"] = round(end_point_error(disp, gt), 3)
    if args.profile:
        if args.oracle or args.mesh or args.aggregation == "box":
            # stage_table profiles the guided JAX single-chip pipeline;
            # profiling a DIFFERENT path than the one that produced the
            # outputs would mislead
            print("error: --profile covers the guided single-chip JAX "
                  "pipeline; it does not combine with --oracle/--mesh/"
                  "--aggregation box", file=sys.stderr)
            return 2
        from .profiling import stage_table, print_stage_table

        print_stage_table(stage_table(left, right, cfg), file=sys.stderr)
    if args.json:
        print(json.dumps(stats))
    else:
        print(f"duration: {dt:.3f} s   ({stats['width']}x{stats['height']}, "
              f"{cfg.size_d} disparities, {stats['occluded_pct']}% occluded)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
