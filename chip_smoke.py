"""End-to-end smoke run of the stereo pipeline on an NVIDIA GPU.

Run from the repository root on a machine with one GPU:

    python chip_smoke.py           # phases 1-4 on one card
    python chip_smoke.py --four    # only the sharded phase, on four cards

Everything that uses JAX runs in this one process (a second JAX process
would find most of the card's memory already reserved).  The only child
processes are ``nvidia-smi`` and, where the native image codec is not
built yet, its one-time ``make -C native``; neither touches JAX.
Frames are rendered from a seed with ``utils/synth.make_scene``.  Each
phase prints one JSON line, and any failed check raises, so the script
exits non-zero; nothing falls back to the CPU.  The last line of standard output is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Phases:

  1. exact-288x384: parity mode (D = 16, disparities -15..0) against the
     NumPy oracle, 0 mismatches required on every buffer; the emulated
     f64 reciprocal against float64 on 10^7 seeded samples; the CLI's
     ``--exact --dump-intermediates`` PNGs against the oracle's; then
     the CLI's ``--eval`` (bad-2.0 at most 5 %) and ``--sequence``.
  2. fast-288x384, fast-6mp: the default configuration through
     ``compute_disparity`` against the oracle, at most TIE_BOUND of the
     pixels differing (WTA near-ties); compile seconds, median frame
     time, memory and the per-stage split.
  3. wide-5.9mp-128: 1988 x 2948, disparities -127..0; the executable's
     memory analysis (an explicit ``d_chunk`` when the whole volume does
     not fit), bad-2.0 on the scene's non-occluded ground truth at most
     5 %, and the phase-2 timings.
  4. serve: the HTTP server in a thread: /healthz, three sequential
     requests and a burst of four concurrent ones, each answer equal to
     ``compute_disparity``'s, the burst micro-batched.

``--four`` runs only ``sharded_stereo_pipeline`` on four cards (batch,
2 x 2 spatial and disparity-range meshes), each compared with the
single-card pipeline in the same process within TIE_BOUND.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import dataclasses
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

# Fraction of pixels the fast path may flip against the oracle: XLA
# reassociates the integral-image sums, which moves exact WTA cost ties
# (the repository's near-tie bound, tests/test_sharded.py).
TIE_BOUND = 2e-3

EXACT_KEYS = ("gray_left", "gray_right", "mean_left", "mean_right",
              "best_cost_left", "best_cost_right",
              "disparity_left", "disparity_right",
              "occlusion", "occlusion_filled")

# CLI --dump-intermediates file -> (oracle buffer, written normalized?)
DUMP_FILES = {
    "disparity_mapl.png": ("disparity_left", True),
    "disparity_mapr.png": ("disparity_right", True),
    "occlu_mapl.png": ("occlusion", True),
    "occlu_mapl_filled.png": ("occlusion_filled", True),
    "image_left.png": ("gray_left", False),
    "image_right.png": ("gray_right", False),
    "image_mean_left.png": ("mean_left", False),
    "image_mean_right.png": ("mean_right", False),
    "best_costl.png": ("best_cost_left", True),
    "best_costr.png": ("best_cost_right", True),
    "cost_lminus15.png": ("cost_left_s0", True),
    "cost_rminus15.png": ("cost_right_s0", True),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def require_gpu(devices=None):
    """First JAX device, or SystemExit when it is not a GPU."""
    import jax

    dev = (devices if devices is not None else jax.devices())[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU; JAX found {dev.platform!r} "
            f"({dev.device_kind})")
    return dev


def card_lines() -> list[str]:
    """``name, power.limit`` of every card, as nvidia-smi prints them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [line.strip() for line in r.stdout.splitlines() if line.strip()]


def _scene(h: int, w: int, ndisp: int, seed: int):
    from stereo_matching.utils.synth import make_scene

    return make_scene(h, w, ndisp=ndisp, seed=seed)


def _memory(compiled) -> dict:
    ma = compiled.memory_analysis()
    keys = ("temp_size_in_bytes", "argument_size_in_bytes",
            "output_size_in_bytes", "alias_size_in_bytes",
            "generated_code_size_in_bytes")
    return {k: int(getattr(ma, k)) for k in keys if hasattr(ma, k)}


def _median_ms(f, n: int) -> float:
    import jax

    jax.block_until_ready(f())   # warm-up
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(f())
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def _compile(left, right, cfg):
    """(compiled stereo_pipeline for this shape and cfg, seconds)."""
    from stereo_matching.pipeline import stereo_pipeline

    t0 = time.perf_counter()
    compiled = stereo_pipeline.lower(left, right, cfg=cfg).compile()
    return compiled, time.perf_counter() - t0


def _mismatches(got: dict, want: dict, keys) -> dict:
    return {k: int((np.asarray(got[k]) != np.asarray(want[k])).sum())
            for k in keys}


def _cli(argv: list) -> dict:
    """Run the CLI in this process; returns the JSON line it prints."""
    from stereo_matching import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    check(rc == 0, f"CLI {argv[-3:]} exited {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def check_recip(n: int, seed: int = 0) -> int:
    """Mismatches of the emulated fl32(1/(var + EPS)) against float64 on
    n seeded samples spanning the variances a guide image produces."""
    import jax

    from stereo_matching.config import DEFAULT_CONFIG
    from stereo_matching.ops.guided import _recip_var_eps

    rng = np.random.default_rng(seed)
    var = np.concatenate([
        rng.uniform(0, 16384, n // 2),
        10 ** rng.uniform(-6, 4.3, n // 4),
        rng.uniform(-1, 1, n - n // 2 - n // 4),
    ]).astype(np.float32)
    eps = DEFAULT_CONFIG.eps
    want = (1.0 / (var.astype(np.float64) + np.float64(eps))).astype(np.float32)
    got = np.asarray(jax.jit(lambda v: _recip_var_eps(v, eps))(var))
    return int((got != want).sum())


def phase_exact(h: int = 288, w: int = 384, n_recip: int = 10 ** 7) -> dict:
    """Parity mode against the oracle, the reciprocal, and the CLI."""
    from stereo_matching import reference as R
    from stereo_matching.config import StereoConfig
    from stereo_matching.pipeline import compute_disparity
    from stereo_matching.utils.io import read_png, write_png

    t_phase = time.perf_counter()
    s = _scene(h, w, 16, seed=1)
    cfg = StereoConfig(exact_integral=True)
    oracle = R.run_pipeline(s["left"], s["right"], cfg)
    oracle["cost_left_s0"] = oracle["cost_left"][0]
    oracle["cost_right_s0"] = oracle["cost_right"][0]
    out = compute_disparity(s["left"], s["right"], cfg, full_outputs=True)
    mism = _mismatches(out, oracle, EXACT_KEYS + ("cost_left_s0", "cost_right_s0"))
    recip = check_recip(n_recip)

    with tempfile.TemporaryDirectory() as tmp:
        lp, rp = os.path.join(tmp, "l.png"), os.path.join(tmp, "r.png")
        write_png(lp, s["left"])
        write_png(rp, s["right"])
        outdir = os.path.join(tmp, "out")
        cli_stats = _cli([lp, rp, "-o", outdir, "--exact",
                          "--dump-intermediates", "--json"])
        png = {}
        for name, (key, normalized) in DUMP_FILES.items():
            want = oracle[key]
            want = R.write_mat_normalize(want) if normalized else want
            png[name] = int((read_png(os.path.join(outdir, name)) != want).sum())

    res = {"shape": [h, w], "disparities": cfg.size_d,
           "mismatches": mism, "recip_samples": n_recip,
           "recip_mismatches": recip, "cli_png_mismatches": png,
           "cli_seconds": cli_stats["seconds"],
           "wall_s": time.perf_counter() - t_phase}
    emit(f"exact-{h}x{w}", **res)
    check(not any(mism.values()), f"exact mode differs from the oracle: {mism}")
    check(recip == 0, f"{recip} reciprocal mismatches")
    check(not any(png.values()), f"CLI PNGs differ from the oracle's: {png}")
    return res


def phase_cli_modes(h: int = 288, w: int = 384, frames: int = 3) -> dict:
    """The CLI's --eval over a Middlebury-layout directory of rendered
    scenes (16 and 64 disparities via calib.txt) and its --sequence mode
    over directories of frames."""
    from stereo_matching.utils.io import write_png
    from stereo_matching.utils.synth import write_scene_dir

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ds = os.path.join(tmp, "dataset")
        for i, ndisp in enumerate((16, 64)):
            write_scene_dir(os.path.join(ds, f"scene{ndisp}"),
                            _scene(h, w, ndisp, seed=30 + i))
        ev = _cli([ds, "--eval", "--json"])
        lefts, rights = os.path.join(tmp, "L"), os.path.join(tmp, "R")
        os.makedirs(lefts)
        os.makedirs(rights)
        for i in range(frames):
            s = _scene(h, w, 16, seed=40 + i)
            write_png(os.path.join(lefts, f"f{i}.png"), s["left"])
            write_png(os.path.join(rights, f"f{i}.png"), s["right"])
        outdir = os.path.join(tmp, "seq")
        seq = _cli([lefts, rights, "-o", outdir, "--sequence", "--json"])
        written = len(os.listdir(outdir))
    bad2 = {name: sc.get("bad_2_0_pct") for name, sc in ev["scenes"].items()}
    res = {"shape": [h, w], "eval_bad_2_0_pct": bad2,
           "eval_ndisp": {n: sc.get("ndisp") for n, sc in ev["scenes"].items()},
           "sequence_frames": seq["frames"], "sequence_outputs": written,
           "sequence_seconds": seq["seconds"],
           "wall_s": time.perf_counter() - t_phase}
    emit("cli-modes", **res)
    check(ev["aggregate"]["scored"] == 2, f"--eval scored {ev['aggregate']}")
    check(all(v is not None and v <= 5.0 for v in bad2.values()),
          f"--eval bad-2.0 above 5%: {bad2}")
    check(seq["frames"] == frames == written,
          f"--sequence wrote {written} of {frames} frames")
    return res


def _timings(left, right, cfg, dev, frames: int, stage_runs: int,
             compiled=None, compile_s=None) -> dict:
    """Compile seconds, memory, median frame ms and the stage split."""
    import jax

    from stereo_matching.profiling import stage_table

    l, r = jax.device_put(left, dev), jax.device_put(right, dev)
    if compiled is None:
        compiled, compile_s = _compile(l, r, cfg)
    frame_ms = _median_ms(lambda: compiled(l, r), frames)
    stages = stage_table(left, right, cfg, n=stage_runs)
    return {"compile_s": compile_s, "memory_analysis": _memory(compiled),
            "frame_ms_median": frame_ms, "frames": frames,
            "stages_ms": {row["stage"]: row["ms"] for row in stages},
            "peak_bytes_in_use": _memory_stat(dev, "peak_bytes_in_use")}


def phase_fast(name: str, h: int, w: int, frames: int = 10,
               stage_runs: int = 5, seed: int = 2) -> dict:
    """Default configuration through compute_disparity vs the oracle."""
    import jax

    from stereo_matching import reference as R
    from stereo_matching.config import DEFAULT_CONFIG as cfg
    from stereo_matching.pipeline import compute_disparity

    t_phase = time.perf_counter()
    dev = jax.devices()[0]
    s = _scene(h, w, cfg.size_d, seed=seed)
    res = {"shape": [h, w], "disparities": cfg.size_d}
    res.update(_timings(s["left"], s["right"], cfg, dev, frames, stage_runs))
    out = compute_disparity(s["left"], s["right"], cfg)
    t0 = time.perf_counter()
    oracle = R.run_pipeline(s["left"], s["right"], cfg)
    res["oracle_s"] = time.perf_counter() - t0
    mism = _mismatches(out, oracle, ("occlusion_filled", "disparity_left"))
    bound = int(TIE_BOUND * h * w)
    res.update(mismatches=mism, mismatch_bound=bound,
               wall_s=time.perf_counter() - t_phase)
    emit(name, **res)
    check(max(mism.values()) <= bound,
          f"{name}: {mism} pixels differ from the oracle (bound {bound})")
    return res


def _memory_stat(dev, key: str):
    """One of ``dev.memory_stats()`` (None on the CPU, which has none):
    "bytes_limit" is what the JAX client may allocate, "peak_bytes_in_use"
    the process-wide peak so far."""
    return (dev.memory_stats() or {}).get(key)


def fit_d_chunk(left, right, cfg, dev, limit, log=None):
    """(cfg, compiled, compile seconds): the first d_chunk in None, D/2,
    D/4, ... whose executable fits in ``limit`` bytes (None: any)."""
    import jax

    l, r = jax.device_put(left, dev), jax.device_put(right, dev)
    chunk = None
    while True:
        c = dataclasses.replace(cfg, d_chunk=chunk)
        compiled, compile_s = _compile(l, r, c)
        mem = _memory(compiled)
        need = (mem.get("temp_size_in_bytes", 0)
                + mem.get("argument_size_in_bytes", 0)
                + mem.get("output_size_in_bytes", 0))
        if log is not None:
            log(d_chunk=chunk, compile_s=compile_s, memory_analysis=mem,
                bytes_limit=limit)
        if limit is None or need <= limit:
            return c, compiled, compile_s
        chunk = (cfg.size_d if chunk is None else chunk) // 2
        check(chunk >= 1 and cfg.size_d % chunk == 0,
              f"no d_chunk fits {limit} bytes")


def phase_wide(h: int = 1988, w: int = 2948, ndisp: int = 128,
               frames: int = 5, stage_runs: int = 3, seed: int = 4) -> dict:
    """Wide disparity range at full resolution, scored on the scene's GT."""
    import jax

    from stereo_matching.config import StereoConfig
    from stereo_matching.metrics import bad_pixel_rate
    from stereo_matching.pipeline import compute_disparity

    name = f"wide-{h}x{w}-{ndisp}"
    t_phase = time.perf_counter()
    dev = jax.devices()[0]
    s = _scene(h, w, ndisp, seed=seed)
    base = StereoConfig(d_min=-(ndisp - 1), d_max=0)
    cfg, compiled, compile_s = fit_d_chunk(
        s["left"], s["right"], base, dev, _memory_stat(dev, "bytes_limit"),
        log=lambda **kw: emit(f"{name}-memory", **kw))
    res = {"shape": [h, w], "disparities": ndisp, "d_chunk": cfg.d_chunk}
    res.update(_timings(s["left"], s["right"], cfg, dev, frames, stage_runs,
                        compiled, compile_s))
    out = compute_disparity(s["left"], s["right"], cfg,
                            keys=("occlusion_filled",))
    disp = np.abs(out["occlusion_filled"].astype(np.float32))
    bad2 = bad_pixel_rate(disp, s["gt"], 2.0)
    res.update(bad_2_0_pct=bad2, wall_s=time.perf_counter() - t_phase)
    emit(name, **res)
    check(bad2 <= 5.0, f"{name}: bad-2.0 {bad2:.3f}% > 5%")
    return res


def _b64_png(img) -> str:
    from stereo_matching.utils.io import write_png

    with tempfile.TemporaryDirectory() as tmp:
        p = os.path.join(tmp, "f.png")
        write_png(p, img)
        with open(p, "rb") as f:
            return base64.b64encode(f.read()).decode("ascii")


def _served_map(rep: dict) -> np.ndarray:
    from stereo_matching.utils.pnm import read_pfm

    with tempfile.TemporaryDirectory() as tmp:
        p = os.path.join(tmp, "d.pfm")
        with open(p, "wb") as f:
            f.write(base64.b64decode(rep["disparity_pfm"]))
        return read_pfm(p)


def phase_serve(h: int = 288, w: int = 384, n_seq: int = 3, n_burst: int = 4,
                platform: str = "gpu", timeout_s: float = 600) -> dict:
    """The HTTP server in a thread of this process, driven over HTTP."""
    from stereo_matching.config import DEFAULT_CONFIG as cfg
    from stereo_matching.pipeline import compute_disparity
    from stereo_matching.serve import make_server, warmup

    t_phase = time.perf_counter()
    srv = make_server("127.0.0.1", 0, cfg, max_batch=n_burst,
                      batch_window_s=0.5)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base_url = f"http://127.0.0.1:{srv.server_address[1]}"

    def post(left, right):
        body = json.dumps({"left": _b64_png(left), "right": _b64_png(right)})
        req = urllib.request.Request(
            base_url + "/disparity", data=body.encode(),
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            rep = json.loads(resp.read())
        rep["client_s"] = time.perf_counter() - t0
        return rep

    try:
        with urllib.request.urlopen(base_url + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        warmup_s = warmup(cfg, h, w, max_batch=n_burst)
        pairs = [_scene(h, w, cfg.size_d, seed=10 + i)
                 for i in range(n_seq + n_burst)]
        seq = [post(p["left"], p["right"]) for p in pairs[:n_seq]]
        burst = [None] * n_burst

        def client(i):
            p = pairs[n_seq + i]
            burst[i] = post(p["left"], p["right"])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_burst)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=timeout_s)
        check(all(r is not None for r in burst), "a burst request got no answer")
        differ = [int((_served_map(rep) != compute_disparity(
            p["left"], p["right"], cfg, keys=("occlusion_filled",))[
                "occlusion_filled"]).sum())
            for p, rep in zip(pairs, seq + burst)]
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=60)
    res = {"shape": [h, w], "backend": health["backend"],
           "device": health["device"], "warmup_s": warmup_s,
           "sequential_client_s": [r["client_s"] for r in seq],
           "sequential_server_s": [r["seconds"] for r in seq],
           "burst_client_s": [r["client_s"] for r in burst],
           "burst_batched_n": [r["batched_n"] for r in burst],
           "pixels_differing": differ,
           "wall_s": time.perf_counter() - t_phase}
    emit("serve", **res)
    check(health["backend"] == platform,
          f"/healthz reports backend {health['backend']!r}")
    check(not any(differ), f"served maps differ from compute_disparity: {differ}")
    check(max(res["burst_batched_n"]) > 1, "the burst was not micro-batched")
    return res


def phase_four(small=(288, 384), big=(1992, 3008), wide=(1988, 2948, 128),
               frames: int = 3, devices=None) -> list[dict]:
    """sharded_stereo_pipeline on four devices against one device."""
    import jax

    from stereo_matching.config import DEFAULT_CONFIG, StereoConfig
    from stereo_matching.parallel import make_mesh, sharded_stereo_pipeline

    devs = list(devices if devices is not None else jax.devices())[:4]
    check(len(devs) == 4, f"--four needs 4 devices, found {len(devs)}")
    dev0 = devs[0]
    keys = ("occlusion_filled", "disparity_left")
    cases = [
        ("four-b4", dict(b=4), small, 16, 4),
        ("four-y2x2", dict(y=2, x=2), big, 16, 1),
        ("four-d4", dict(d=4), wide[:2], wide[2], 1),
    ]
    results = []
    for name, mesh_kw, (h, w), ndisp, nb in cases:
        t_phase = time.perf_counter()
        cfg = (DEFAULT_CONFIG if ndisp == 16
               else StereoConfig(d_min=-(ndisp - 1), d_max=0))
        scenes = [_scene(h, w, ndisp, seed=20 + i) for i in range(nb)]
        left = np.stack([s["left"] for s in scenes])
        right = np.stack([s["right"] for s in scenes])
        mesh = make_mesh(**mesh_kw, devices=devs)
        t0 = time.perf_counter()
        out = jax.block_until_ready(
            sharded_stereo_pipeline(left, right, mesh, cfg))
        first_s = time.perf_counter() - t0
        frame_ms = _median_ms(
            lambda: sharded_stereo_pipeline(left, right, mesh, cfg), frames) / nb
        sharded = {k: np.asarray(out[k]) for k in keys}
        single_cfg, compiled, _ = fit_d_chunk(
            left[0], right[0], cfg, dev0, _memory_stat(dev0, "bytes_limit"))
        mism = []
        single_ms = None
        for i in range(nb):
            l0 = jax.device_put(left[i], dev0)
            r0 = jax.device_put(right[i], dev0)
            one = compiled(l0, r0)
            if i == 0:
                single_ms = _median_ms(lambda: compiled(l0, r0), frames)
            mism.append({k: int((sharded[k][i] != np.asarray(one[k])).sum())
                         for k in keys})
        bound = int(TIE_BOUND * h * w)
        res = {"mesh": mesh_kw, "shape": [h, w], "frames": nb,
               "disparities": ndisp, "first_call_s": first_s,
               "frame_ms_median": frame_ms, "single_frame_ms_median": single_ms,
               "single_d_chunk": single_cfg.d_chunk,
               "mismatches": mism, "mismatch_bound": bound,
               "wall_s": time.perf_counter() - t_phase}
        emit(name, **res)
        worst = max(max(m.values()) for m in mism)
        check(worst <= bound,
              f"{name}: {worst} pixels differ from one device (bound {bound})")
        results.append(res)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded phase, on four GPUs")
    args = ap.parse_args(argv)

    import jax

    from stereo_matching.compile_cache import enable_compile_cache

    dev = require_gpu()
    cache = enable_compile_cache()
    cards = card_lines()
    emit("card", nvidia_smi=cards, device_kind=dev.device_kind,
         count=len(jax.devices()), jax=jax.__version__, compile_cache=cache)
    for line in cards:
        print(line, flush=True)
    if args.four:
        phase_four()
    else:
        phase_exact()
        phase_cli_modes()
        phase_fast("fast-288x384", 288, 384)
        phase_fast("fast-6mp", 1992, 3008, seed=3)
        phase_wide()
        phase_serve()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
