"""Long-lived stereo serving mode (stdlib HTTP, no dependencies).

The reference is a one-shot CLI; this framework additionally targets
production serving, where a long-lived process is the natural unit —
and also the performance unit: jit executables are compiled once per
(shape, config) and then served from the in-process cache;
`--serve-warmup HxW` pays that compile at startup instead of inside
the first request.

Protocol (JSON over HTTP, images base64):

  GET  /healthz             → {"status", "backend", "device",
                               "frames_served", "uptime_s"}
  POST /disparity           body {"left": b64, "right": b64,
                               optional "d_min", "d_max"}
       → {"disparity_png": b64 uint8 PNG (write_mat-normalized, the
          reference's artifact convention), "disparity_pfm": b64 PFM
          (raw float disparities incl. the -115 occlusion fill),
          "height", "width", "occluded_pixels", "occluded_pct",
          "seconds", "batched_n"}

Request bodies above 256 MB are rejected with 413 before reading.

Concurrent same-shape requests micro-batch into one device pass
(BatchExecutor below; `--serve-batch N` caps the batch, 1 disables).
Outputs come back in one stacked int16 device→host transfer (exact for
disparity maps).

Per-request "d_min"/"d_max" overrides are honored but EXPENSIVE on a
cold cache: each new (image shape, disparity range) jit-compiles a
fresh executable while the device is held, stalling every concurrent
/disparity request behind it and growing the in-process jit cache.  Deployments that cannot afford that pass
`allowed_d_ranges` (a set of (d_min, d_max) pairs; CLI
`--serve-ranges`) and non-allowlisted overrides get 403 instead of a
compile.

Any decodable input format works (PNG/JPEG/PNM/BMP/TGA/GIF/PSD/HDR/
PIC — read_image's surface; float-HDR and 16-bit inputs reach the
8-bit validation error) — images are passed as bytes and sniffed the
same way.
"""

from __future__ import annotations

import base64
import json
import os
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .config import StereoConfig
from .metrics import occlusion_stats

# One POST buffers the raw body plus its base64-decoded copy before any
# validation; cap it so a single oversized request cannot OOM the
# long-lived serving process (a 6 MP RGB pair is ~50 MB as base64 PNG).
_MAX_BODY_BYTES = 256 << 20


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _decode_image(b64: str) -> np.ndarray:
    """base64 bytes → image array via the magic-sniffing reader (the
    readers are file-path based; round-trip through a temp file)."""
    raw = base64.b64decode(b64, validate=True)
    fd, path = tempfile.mkstemp(suffix=".img")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(raw)
        from .utils.io import read_image

        try:
            return read_image(path)
        except ValueError:
            from .utils.imagefmt import read_tga

            return read_tga(path)   # TGA has no magic; last resort
    finally:
        os.unlink(path)


def _encode_file(write_fn, arr) -> str:
    fd, path = tempfile.mkstemp(suffix=".out")
    os.close(fd)
    try:
        write_fn(path, arr)
        with open(path, "rb") as f:
            return base64.b64encode(f.read()).decode("ascii")
    finally:
        os.unlink(path)


class _Request:
    """One queued /disparity request awaiting device time."""

    __slots__ = ("left", "right", "cfg", "event", "result", "error",
                 "batched_n")

    def __init__(self, left, right, cfg):
        self.left = left
        self.right = right
        self.cfg = cfg
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.batched_n = 1


class BatchExecutor:
    """Micro-batching device executor (VERDICT r4 #3).

    One worker thread owns the device; handler threads submit requests
    and block on a per-request event.  All queued requests with the
    SAME frame shape and config coalesce into one
    ``stereo_pipeline_batch`` call — N concurrent clients then share
    one device pass instead of serializing N single-frame passes
    behind a lock.  Requests with differing shapes/configs run singly.

    Batches are padded up to power-of-two sizes (2/4/8, repeating the
    last frame) so a long-lived server compiles at most
    log2(max_batch) batch executables per (shape, config) instead of
    one per observed batch size.

    ``window_s`` optionally sleeps after the first dequeue so near-
    simultaneous requests can coalesce; the default 0 adds no latency
    (whatever is already queued when the device frees up batches).
    """

    _KEYS = ("occlusion_filled", "occlusion")

    def __init__(self, max_batch: int = 8, window_s: float = 0.0):
        # round DOWN to a power of two: batches pad up to pow2 sizes,
        # so a non-pow2 cap (e.g. 6) would otherwise pad past the cap
        # AND past what warmup compiled (review r5)
        mb = max(1, int(max_batch))
        self.max_batch = mb if mb == _next_pow2(mb) else _next_pow2(mb) // 2
        self.window_s = window_s
        self._q: list[_Request] = []
        self._cv = threading.Condition()
        self._thread = None

    def submit(self, left, right, cfg) -> _Request:
        """Blocks until the request is served; returns it with
        ``result`` (dict of numpy outputs) or ``error`` set."""
        req = _Request(left, right, cfg)
        with self._cv:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._worker, daemon=True,
                    name="stereo-batch-executor")
                self._thread.start()
            self._q.append(req)
            self._cv.notify()
        req.event.wait()
        return req

    # ---- worker side -------------------------------------------------
    def _worker(self):
        while True:
            with self._cv:
                while not self._q:
                    self._cv.wait()
            if self.window_s:
                time.sleep(self.window_s)
            with self._cv:
                items, self._q = self._q, []
            # group by (shape, cfg) in first-arrival order
            groups: dict = {}
            for it in items:
                groups.setdefault((it.left.shape, it.cfg), []).append(it)
            for (_, cfg), reqs in groups.items():
                for i in range(0, len(reqs), self.max_batch):
                    self._run_group(reqs[i:i + self.max_batch], cfg)

    def _run_group(self, reqs: list, cfg: StereoConfig):
        from .pipeline import compute_disparity_stacked, stereo_pipeline_batch

        try:
            if len(reqs) == 1 or self.max_batch == 1:
                for r in reqs:
                    # one stacked device→host transfer per request
                    r.result = compute_disparity_stacked(
                        r.left, r.right, cfg, keys=self._KEYS,
                        compact=True)
                    r.batched_n = 1
                    r.event.set()
                return
            bp = _next_pow2(len(reqs))
            lefts = np.stack([r.left for r in reqs]
                             + [reqs[-1].left] * (bp - len(reqs)))
            rights = np.stack([r.right for r in reqs]
                              + [reqs[-1].right] * (bp - len(reqs)))
            import jax.numpy as jnp

            out = stereo_pipeline_batch(
                jnp.asarray(lefts), jnp.asarray(rights), cfg)
            # whole batch, both outputs: ONE stacked int16 fetch
            # (exact while every emittable value fits int16 — same
            # guard as compute_disparity_stacked; halves the bytes)
            stacked = jnp.stack([out[k] for k in self._KEYS])
            if cfg.d_occlusion >= -32768 and cfg.d_max <= 32767:
                arr = np.asarray(stacked.astype(jnp.int16)
                                 ).astype(np.float32)
            else:
                arr = np.asarray(stacked)
            for i, r in enumerate(reqs):
                r.result = {k: arr[j][i] for j, k in enumerate(self._KEYS)}
                r.batched_n = len(reqs)
                r.event.set()
        except Exception as e:   # surface to every waiting handler
            for r in reqs:
                if not r.event.is_set():
                    r.error = e
                    r.event.set()


class StereoServer(ThreadingHTTPServer):
    """HTTP server holding the config, the micro-batching device
    executor and serving stats.  Port 0 picks an ephemeral port
    (tests)."""

    daemon_threads = True

    def __init__(self, addr, cfg: StereoConfig, allowed_d_ranges=None,
                 max_batch: int = 8, batch_window_s: float = 0.0):
        super().__init__(addr, _Handler)
        self.cfg = cfg
        self.executor = BatchExecutor(max_batch, batch_window_s)
        self.stats_lock = threading.Lock()
        self.frames_served = 0
        self.t_start = time.time()
        # None = any override allowed (each new range pays a compile);
        # else a collection of permitted (d_min, d_max) pairs.
        self.allowed_d_ranges = (
            None if allowed_d_ranges is None
            else {(int(a), int(b)) for a, b in allowed_d_ranges})


class _Handler(BaseHTTPRequestHandler):
    server: StereoServer

    def log_message(self, fmt, *args):   # structured one-line log
        print(f"serve: {self.address_string()} {fmt % args}", flush=True)

    def _reply(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path != "/healthz":
            return self._reply(404, {"error": f"unknown path {self.path}"})
        import jax

        dev = jax.devices()[0]
        self._reply(200, {
            "status": "ok",
            "backend": jax.default_backend(),
            "device": dev.device_kind,
            "frames_served": self.server.frames_served,
            "uptime_s": round(time.time() - self.server.t_start, 1),
        })

    def do_POST(self):
        if self.path != "/disparity":
            return self._reply(404, {"error": f"unknown path {self.path}"})
        try:
            n = int(self.headers.get("Content-Length", "0"))
            if n > _MAX_BODY_BYTES:
                return self._reply(413, {
                    "error": f"body {n} bytes exceeds the "
                             f"{_MAX_BODY_BYTES}-byte limit"})
            req = json.loads(self.rfile.read(n))
            left = _decode_image(req["left"])
            right = _decode_image(req["right"])
        except KeyError as e:
            return self._reply(400, {"error": f"missing field {e}"})
        except Exception as e:  # bad b64 / undecodable image / bad json
            return self._reply(400, {"error": f"bad request: {e}"})
        cfg = self.server.cfg
        try:
            import dataclasses

            if "d_min" in req or "d_max" in req:
                d_min = req.get("d_min", cfg.d_min)
                d_max = req.get("d_max", cfg.d_max)
                if not all(isinstance(v, int) and not isinstance(v, bool)
                           for v in (d_min, d_max)):
                    raise ValueError(
                        f"d_min/d_max must be integers, got "
                        f"{d_min!r}/{d_max!r}")
                allowed = self.server.allowed_d_ranges
                if allowed is not None and (d_min, d_max) not in allowed:
                    return self._reply(403, {
                        "error": f"disparity range ({d_min}, {d_max}) not "
                                 f"in the server allowlist "
                                 f"{sorted(allowed)}"})
                cfg = dataclasses.replace(cfg, d_min=d_min, d_max=d_max)
            if left.ndim != 3 or left.shape != right.shape:
                raise ValueError(
                    f"need same-shaped color pairs, got {left.shape} vs "
                    f"{right.shape}")
            if left.dtype != np.uint8:
                raise ValueError(f"images must be 8-bit, got {left.dtype}")
            t0 = time.time()
            # the executor serializes device work and coalesces
            # concurrent same-shape requests into one batched pass;
            # it fetches only the outputs the response uses
            req_item = self.server.executor.submit(left, right, cfg)
            if req_item.error is not None:
                raise req_item.error
            out = req_item.result
            dt = time.time() - t0
        except (ValueError, NotImplementedError) as e:
            return self._reply(400, {"error": str(e)})
        except Exception as e:  # unexpected (jax runtime, OOM, ...): the
            # request must still get an HTTP response, not a dropped socket
            return self._reply(500, {"error": f"{type(e).__name__}: {e}"})
        filled = out["occlusion_filled"].astype(np.float32)

        from .utils.io import write_mat_normalize, write_png
        from .utils.pnm import write_pfm

        png_b64 = _encode_file(write_png, write_mat_normalize(filled))
        pfm_b64 = _encode_file(write_pfm, filled)
        with self.server.stats_lock:
            self.server.frames_served += 1
        self._reply(200, {
            "disparity_png": png_b64,
            "disparity_pfm": pfm_b64,
            "height": int(filled.shape[0]),
            "width": int(filled.shape[1]),
            "seconds": round(dt, 4),
            "batched_n": req_item.batched_n,
            **occlusion_stats(out["occlusion"], cfg.v_min),
        })


def make_server(host: str, port: int, cfg: StereoConfig,
                allowed_d_ranges=None, max_batch: int = 8,
                batch_window_s: float = 0.0) -> StereoServer:
    return StereoServer((host, port), cfg, allowed_d_ranges,
                        max_batch, batch_window_s)


def warmup(cfg: StereoConfig, h: int, w: int, max_batch: int = 1) -> float:
    """Compile the serving executable for (h, w) frames before the
    first request.  With ``max_batch`` > 1 also
    compiles the micro-batch executables (power-of-two sizes up to
    max_batch) so the first concurrent burst does not pay them.
    Returns the total compile+first-frame seconds."""
    from .pipeline import compute_disparity_stacked, stereo_pipeline_batch

    rng = np.random.default_rng(0)
    pair = rng.integers(0, 256, size=(2, h, w, 3), dtype=np.uint8)
    t0 = time.time()
    compute_disparity_stacked(pair[0], pair[1], cfg,
                              keys=BatchExecutor._KEYS, compact=True)
    if max_batch > 1:
        import jax.numpy as jnp

        b = 2
        while b <= max_batch:
            lefts = jnp.asarray(np.stack([pair[0]] * b))
            rights = jnp.asarray(np.stack([pair[1]] * b))
            out = stereo_pipeline_batch(lefts, rights, cfg)
            # includes the batched stacked-fetch executable the
            # executor's group path dispatches (same int16 guard)
            stacked = jnp.stack([out[k] for k in BatchExecutor._KEYS])
            if cfg.d_occlusion >= -32768 and cfg.d_max <= 32767:
                stacked = stacked.astype(jnp.int16)
            np.asarray(stacked)
            b *= 2
    return time.time() - t0


def serve_forever(host: str, port: int, cfg: StereoConfig,
                  allowed_d_ranges=None, warmup_hw=None,
                  max_batch: int = 8) -> None:
    srv = make_server(host, port, cfg, allowed_d_ranges, max_batch)
    import jax

    from .compile_cache import enable_compile_cache

    enable_compile_cache()
    if warmup_hw is not None:
        h, w = warmup_hw
        print(f"stereo server warming up {h}x{w} executable "
              f"(jit compile; batch sizes up to {max_batch})...",
              flush=True)
        dt = warmup(cfg, h, w, max_batch)
        print(f"stereo server warmup done in {dt:.1f}s", flush=True)
    print(f"stereo server on {srv.server_address[0]}:"
          f"{srv.server_address[1]} (backend {jax.default_backend()}); "
          "POST /disparity, GET /healthz", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        print("stereo server shutting down", flush=True)
    finally:
        srv.server_close()
