"""HTTP serving mode (serve.py): the long-lived process that amortizes
per-process jit compiles."""

import base64
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from stereo_matching.config import StereoConfig
from stereo_matching.serve import make_server


def _b64_png(img):
    import tempfile, os

    from stereo_matching.utils.png import write_png

    fd, path = tempfile.mkstemp(suffix=".png")
    os.close(fd)
    try:
        write_png(path, img)
        with open(path, "rb") as f:
            return base64.b64encode(f.read()).decode()
    finally:
        os.unlink(path)


@pytest.fixture(scope="module")
def server():
    srv = make_server("127.0.0.1", 0, StereoConfig(d_min=-7, d_max=0))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.shutdown()
    srv.server_close()


def _post(server, payload, timeout=600):
    url = f"http://127.0.0.1:{server.server_address[1]}/disparity"
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _pair(h=40, w=72, shift=6):
    rng = np.random.default_rng(9)
    base = rng.integers(0, 256, (h, w + shift + 2, 3), dtype=np.uint8)
    return base[:, shift:-2], base[:, : -shift - 2]


def test_healthz(server):
    url = f"http://127.0.0.1:{server.server_address[1]}/healthz"
    with urllib.request.urlopen(url, timeout=60) as r:
        rep = json.loads(r.read())
    assert rep["status"] == "ok"
    assert rep["backend"] in ("cpu", "gpu")
    assert rep["frames_served"] >= 0


def test_disparity_matches_pipeline(server):
    from stereo_matching.pipeline import compute_disparity
    from stereo_matching.utils.pnm import read_pfm
    import tempfile, os

    left, right = _pair()
    rep = _post(server, {"left": _b64_png(left), "right": _b64_png(right)})
    assert rep["height"] == 40 and rep["width"] == 72
    assert rep["seconds"] > 0
    fd, path = tempfile.mkstemp(suffix=".pfm")
    os.close(fd)
    try:
        with open(path, "wb") as f:
            f.write(base64.b64decode(rep["disparity_pfm"]))
        served = read_pfm(path)
    finally:
        os.unlink(path)
    want = compute_disparity(left, right, server.cfg)["occlusion_filled"]
    np.testing.assert_array_equal(served, want.astype(np.float32))
    # the PNG artifact is the write_mat-normalized map
    from stereo_matching import reference as R
    from stereo_matching.utils.png import read_png

    fd, path = tempfile.mkstemp(suffix=".png")
    os.close(fd)
    try:
        with open(path, "wb") as f:
            f.write(base64.b64decode(rep["disparity_png"]))
        png = read_png(path)
    finally:
        os.unlink(path)
    np.testing.assert_array_equal(
        png, R.write_mat_normalize(want.astype(np.float32)))


def test_disparity_range_override(server):
    left, right = _pair()
    rep = _post(server, {"left": _b64_png(left), "right": _b64_png(right),
                         "d_min": -3, "d_max": 0})
    assert rep["height"] == 40


def test_repeat_requests_count(server):
    left, right = _pair()
    before = json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{server.server_address[1]}/healthz",
        timeout=60).read())["frames_served"]
    _post(server, {"left": _b64_png(left), "right": _b64_png(right)})
    after = json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{server.server_address[1]}/healthz",
        timeout=60).read())["frames_served"]
    assert after == before + 1


@pytest.mark.parametrize("payload,msg", [
    ({"right": "aGk="}, "missing field"),               # no left
    ({"left": "aGk=", "right": "aGk="}, "bad request"),  # not an image
])
def test_bad_requests_rejected(server, payload, msg):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, payload)
    assert e.value.code == 400
    rep = json.loads(e.value.read())
    assert msg.split()[0] in rep["error"]


def test_shape_mismatch_rejected(server):
    left, _ = _pair()
    other = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, {"left": _b64_png(left), "right": _b64_png(other)})
    assert e.value.code == 400


def test_null_range_rejected_400(server):
    # a non-int d_min must be a clean 400, not an escaped TypeError that
    # drops the connection (ADVICE r3)
    left, right = _pair()
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, {"left": _b64_png(left), "right": _b64_png(right),
                       "d_min": None})
    assert e.value.code == 400
    assert "must be integers" in json.loads(e.value.read())["error"]


def test_oversized_body_413(server):
    # the server must reject on the Content-Length header BEFORE
    # buffering the body (ADVICE r3); send the header with a tiny body
    url = f"http://127.0.0.1:{server.server_address[1]}/disparity"
    req = urllib.request.Request(
        url, data=b"{}", headers={"Content-Type": "application/json"})
    req.add_unredirected_header("Content-Length", str(1 << 30))
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 413


def test_range_allowlist_403():
    srv = make_server("127.0.0.1", 0, StereoConfig(d_min=-7, d_max=0),
                      allowed_d_ranges=[(-7, 0), (-3, 0)])
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        left, right = _pair()
        rep = _post(srv, {"left": _b64_png(left), "right": _b64_png(right),
                          "d_min": -3, "d_max": 0})
        assert rep["height"] == 40
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv, {"left": _b64_png(left), "right": _b64_png(right),
                        "d_min": -5, "d_max": 0})
        assert e.value.code == 403
        assert "allowlist" in json.loads(e.value.read())["error"]
    finally:
        srv.shutdown()
        srv.server_close()


def test_unknown_path_404(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(
            f"http://127.0.0.1:{server.server_address[1]}/nope", timeout=60)
    assert e.value.code == 404


def test_cli_serve_flag_validation():
    from stereo_matching.cli import main

    assert main(["--serve", "0", "--eval"]) == 2
    assert main(["left.png", "right.png", "--serve", "0"]) == 2


def test_warmup_compiles_and_counts_nothing():
    """serve.warmup compiles the (h, w) executable without touching the
    request counter; the CLI flag parses HxW and rejects junk."""
    from stereo_matching import cli
    from stereo_matching.serve import warmup

    dt = warmup(StereoConfig(d_min=-3, d_max=0), 24, 40)
    assert dt > 0
    args = cli.build_parser().parse_args(
        ["--serve", "0", "--serve-warmup", "288x384"])
    assert args.serve_warmup == "288x384"
    assert cli.main(["--serve", "0", "--serve-warmup", "nonsense"]) == 2


def test_concurrent_requests_microbatch():
    """N concurrent same-shape clients coalesce into batched device
    passes (VERDICT r4 #3): all succeed, at least one response reports
    batched_n >= 2, and every served map equals the single-frame
    pipeline output exactly."""
    from stereo_matching.pipeline import compute_disparity
    from stereo_matching.utils.pnm import read_pfm
    import os
    import tempfile

    cfg = StereoConfig(d_min=-7, d_max=0)
    # generous coalesce window: CPU compile/runtime jitter otherwise
    # makes the queue state timing-dependent
    srv = make_server("127.0.0.1", 0, cfg, batch_window_s=0.5)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        pairs = []
        rng = np.random.default_rng(21)
        for i in range(6):
            base = rng.integers(0, 256, (40, 80, 3), dtype=np.uint8)
            pairs.append((base[:, 8:], base[:, :-8]))
        # warm the single-frame executable so the concurrent burst is
        # not serialized behind one long first compile
        _post(srv, {"left": _b64_png(pairs[0][0]),
                    "right": _b64_png(pairs[0][1])})

        results = [None] * len(pairs)

        def client(i):
            left, right = pairs[i]
            results[i] = _post(
                srv, {"left": _b64_png(left), "right": _b64_png(right)})

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(pairs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        assert all(r is not None for r in results)
        assert max(r["batched_n"] for r in results) >= 2, (
            [r["batched_n"] for r in results])
        # batched outputs must equal the single-frame pipeline exactly
        for (left, right), rep in zip(pairs, results):
            fd, path = tempfile.mkstemp(suffix=".pfm")
            os.close(fd)
            try:
                with open(path, "wb") as f:
                    f.write(base64.b64decode(rep["disparity_pfm"]))
                served = read_pfm(path)
            finally:
                os.unlink(path)
            want = compute_disparity(left, right, cfg)["occlusion_filled"]
            np.testing.assert_array_equal(served, want.astype(np.float32))
    finally:
        srv.shutdown()
        srv.server_close()


def test_batch_cap_rounds_down_to_pow2():
    """A non-power-of-two --serve-batch must round DOWN: batches pad up
    to pow2 sizes, so a cap of 6 would otherwise build 8-frame batches
    past the cap and past what warmup compiled (review r5)."""
    from stereo_matching.serve import BatchExecutor

    assert BatchExecutor(max_batch=6).max_batch == 4
    assert BatchExecutor(max_batch=8).max_batch == 8
    assert BatchExecutor(max_batch=1).max_batch == 1
    assert BatchExecutor(max_batch=3).max_batch == 2
