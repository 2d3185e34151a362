"""profiling.stage_table / print_stage_table / trace — the framework's
answer to the reference's Nsight CSV exports (SURVEY.md §5/§6)."""

import io
import os

import numpy as np
import jax
import pytest

from stereo_matching import profiling
from stereo_matching.config import DEFAULT_CONFIG as CFG


def _pair(h=24, w=48, seed=7):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(h, w + 16, 3), dtype=np.uint8)
    return base[:, 16:], base[:, :-16]


def test_stage_table_structure_and_totals():
    left, right = _pair()
    rows = profiling.stage_table(left, right, CFG, n=2)
    names = [r["stage"] for r in rows]
    assert names == profiling.STAGES + ["TOTAL"]
    # timings are wall-clock and noisy on CPU — assert structure only
    for r in rows:
        assert isinstance(r["ms"], float)
        assert r["ms"] >= 0.0 and np.isfinite(r["ms"])
    assert rows[-1]["ms"] == pytest.approx(sum(r["ms"] for r in rows[:-1]))


def test_stage_table_wide_range_chunked():
    """A chunked wide-range config (the d_chunk path of the guided
    stage) profiles through the same stages."""
    import dataclasses

    left, right = _pair()
    cfg = dataclasses.replace(CFG, d_min=-31, d_max=0, d_chunk=8)
    rows = profiling.stage_table(left, right, cfg, n=1)
    assert [r["stage"] for r in rows][:-1] == profiling.STAGES
    for r in rows:
        assert r["ms"] >= 0.0 and np.isfinite(r["ms"])
    with pytest.raises(ValueError):
        profiling.stage_table(left, right, cfg, n=0)


def test_print_stage_table_formatting():
    rows = [{"stage": "gray", "ms": 1.234}, {"stage": "TOTAL", "ms": 5.0}]
    buf = io.StringIO()
    profiling.print_stage_table(rows, file=buf)
    out = buf.getvalue().splitlines()
    assert len(out) == 2
    assert out[0].startswith("gray") and "1.234 ms" in out[0]
    assert out[1].startswith("TOTAL") and "5.000 ms" in out[1]


def test_trace_context_writes_profile(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir):
        jax.block_until_ready(jax.jit(lambda x: x * 2)(np.arange(8.0)))
    found = []
    for root, _dirs, files in os.walk(logdir):
        found += files
    assert found, "trace() produced no profiler artifacts"


def test_batch_stage_table_structure():
    """batch_stage_table profiles the batched (vmap) structure and
    reports per-frame ms; rejects non-batched input."""
    left, right = _pair()
    bl = np.stack([left] * 3)
    br = np.stack([right] * 3)
    rows = profiling.batch_stage_table(bl, br, CFG, n=2)
    names = [r["stage"] for r in rows]
    assert names[:-1] == profiling.STAGES
    assert names[-1] == "TOTAL (per frame, B=3)"
    for r in rows:
        assert r["ms"] >= 0.0 and np.isfinite(r["ms"])
    with pytest.raises(ValueError):
        profiling.batch_stage_table(left, right, CFG)
