"""Per-stage timing + tracing — the framework's answer to the
reference's committed Nsight CSVs (report/csv_file_nsight_*/, SURVEY.md
§5/§6).

Two tools:

  * ``stage_table(left, right, cfg)`` — per-stage device-time table in
    the same shape as SURVEY.md §6.  Each stage (grayscale, cost, guided
    aggregation + WTA, LR check, fill) runs as its own jitted executable
    on the previous stage's materialized outputs, timed with the host
    clock around ``block_until_ready`` (median of ``n`` runs after a
    compile-and-warm-up call).  The composed one-jit pipeline may fuse
    across stage boundaries, so the sum of the stages can differ from a
    whole-frame time.
  * ``trace(logdir)`` — a jax.profiler trace context for TensorBoard /
    xprof when device traces are wanted.
"""

from __future__ import annotations

import contextlib
import statistics
import time

import jax
import jax.numpy as jnp

from .config import StereoConfig, DEFAULT_CONFIG
from . import ops


def _stages(cfg: StereoConfig):
    """[(name, fn)]: each fn maps the pipeline state dict to the entries
    its stage adds."""

    def gray(s):
        return {"gl": ops.rgb_to_grayscale(s["l"], cfg),
                "gr": ops.rgb_to_grayscale(s["r"], cfg)}

    def cost(s):
        return {"cl": ops.cost_volume(s["gl"], s["gr"], cfg.d_min, cfg),
                "cr": ops.cost_volume(s["gr"], s["gl"], cfg.d_min_right, cfg)}

    def guided(s):
        _, dl, _ = ops.guided_filter_wta(s["gl"], s["cl"], cfg.d_min, cfg)
        _, dr, _ = ops.guided_filter_wta(s["gr"], s["cr"], cfg.d_min_right, cfg)
        return {"dl": dl, "dr": dr}

    def detect(s):
        return {"occ": ops.detect_occlusion(s["dl"], s["dr"], cfg.d_occlusion, cfg)}

    def fill(s):
        return {"filled": ops.fill_occlusion(s["occ"], cfg.v_min, cfg)}

    return [
        ("rgb_to_grayscale x2", gray),
        ("cost_volume x2", cost),
        ("guided_filter+WTA x2", guided),
        ("detect_occlusion", detect),
        ("fill_occlusion", fill),
    ]


STAGES = [name for name, _ in _stages(DEFAULT_CONFIG)]


def _timed(f, state, n: int):
    """(median seconds of n calls, output) after a compile + warm-up call."""
    out = jax.block_until_ready(f(state))
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(f(state))
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def _table(left, right, cfg: StereoConfig, n: int, batched: bool):
    if n < 1:
        raise ValueError(f"stage tables need n >= 1 runs, got {n}")
    state = {"l": jnp.asarray(left), "r": jnp.asarray(right)}
    rows = []
    for name, fn in _stages(cfg):
        t, out = _timed(jax.jit(jax.vmap(fn) if batched else fn), state, n)
        rows.append((name, t))
        state.update(out)
    return rows


def stage_table(left, right, cfg: StereoConfig = DEFAULT_CONFIG,
                n: int = 5) -> list[dict]:
    """Returns [{stage, ms}]: per-frame device ms of each stage of the
    single-frame pipeline, then their sum as "TOTAL"."""
    rows = _table(left, right, cfg, n, batched=False)
    out = [{"stage": name, "ms": t * 1e3} for name, t in rows]
    out.append({"stage": "TOTAL", "ms": sum(t for _, t in rows) * 1e3})
    return out


def batch_stage_table(left, right, cfg: StereoConfig = DEFAULT_CONFIG,
                      n: int = 5) -> list[dict]:
    """Per-FRAME device ms per stage of the batched pipeline's structure
    ((B,H,W,C) inputs through a ``vmap`` of each stage, exactly like
    stereo_pipeline_batch) — the analysis surface for sequence-throughput
    work: a stage whose per-frame cost matches the single-frame table is
    pure per-frame work that batching cannot amortize."""
    if left.ndim != 4:
        raise ValueError(f"batch_stage_table needs (B,H,W,C), got {left.shape}")
    b = left.shape[0]
    rows = _table(left, right, cfg, n, batched=True)
    out = [{"stage": name, "ms": t / b * 1e3} for name, t in rows]
    out.append({"stage": f"TOTAL (per frame, B={b})",
                "ms": sum(t for _, t in rows) / b * 1e3})
    return out


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace context (TensorBoard-compatible)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def print_stage_table(rows: list[dict], file=None) -> None:
    width = max(len(r["stage"]) for r in rows)
    for r in rows:
        print(f"{r['stage']:<{width}}  {r['ms']:>10.3f} ms", file=file)
