"""chip_smoke.py's helpers on the CPU: it refuses a CPU device, the
compile-cache rule, and each phase at a tiny size (the card runs them at
full size)."""

import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke as cs
from stereo_matching import compile_cache
from stereo_matching.config import DEFAULT_CONFIG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        cs.require_gpu()


def test_main_refuses_cpu_and_prints_no_result(capsys):
    with pytest.raises(SystemExit) as e:
        cs.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_fails(tmp_path):
    """Copied into a directory without the repository, the script exits
    non-zero and prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir_rule(monkeypatch, tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins and nothing is set; without it the
    cache goes to one fixed directory in the checkout that .gitignore
    lists."""
    updates = []
    monkeypatch.setattr(compile_cache.jax.config, "update",
                        lambda *a: updates.append(a))
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        got = compile_cache.enable_compile_cache()
        assert got == compile_cache.CACHE_DIR
        assert os.path.dirname(got) == REPO
        assert updates == [("jax_compilation_cache_dir", got)]
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert os.path.basename(got) + "/" in f.read().split()
    else:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
        assert compile_cache.enable_compile_cache() == want
        assert updates == []


def test_recip_ten_million_samples():
    assert cs.check_recip(10 ** 7) == 0


def test_phase_exact_tiny():
    res = cs.phase_exact(48, 64, n_recip=10 ** 5)
    assert not any(res["mismatches"].values())
    assert len(res["cli_png_mismatches"]) == 12


def test_phase_cli_modes_tiny():
    res = cs.phase_cli_modes(192, 288, frames=2)
    assert set(res["eval_ndisp"].values()) == {16, 64}
    assert res["sequence_frames"] == res["sequence_outputs"] == 2


def test_phase_fast_tiny(capsys):
    res = cs.phase_fast("fast-tiny", 48, 64, frames=1, stage_runs=1)
    assert res["mismatches"]["occlusion_filled"] <= res["mismatch_bound"]
    assert set(res["stages_ms"]) >= {"cost_volume x2", "TOTAL"}
    assert '"phase": "fast-tiny"' in capsys.readouterr().out


def test_phase_wide_tiny():
    res = cs.phase_wide(160, 224, 16, frames=1, stage_runs=1)
    assert res["d_chunk"] is None and res["bad_2_0_pct"] <= 5.0


def test_fit_d_chunk_halves_until_it_fits():
    import jax

    s = cs._scene(48, 64, 16, seed=3)
    dev = jax.devices()[0]
    _, compiled, _ = cs.fit_d_chunk(s["left"], s["right"], DEFAULT_CONFIG,
                                    dev, None)
    mem = cs._memory(compiled)
    whole = sum(mem[k] for k in ("temp_size_in_bytes",
                                 "argument_size_in_bytes",
                                 "output_size_in_bytes"))
    seen = []
    cfg, _, _ = cs.fit_d_chunk(s["left"], s["right"], DEFAULT_CONFIG, dev,
                               whole - 1,
                               log=lambda **kw: seen.append(kw["d_chunk"]))
    assert seen[0] is None and cfg.d_chunk == seen[-1] and cfg.d_chunk < 16
    with pytest.raises(AssertionError, match="no d_chunk fits"):
        cs.fit_d_chunk(s["left"], s["right"], DEFAULT_CONFIG, dev, 1)


def test_phase_serve_tiny():
    res = cs.phase_serve(40, 64, platform="cpu")
    assert res["backend"] == "cpu"
    assert max(res["burst_batched_n"]) > 1
    assert not any(res["pixels_differing"])


def test_phase_four_tiny():
    import jax

    res = cs.phase_four(small=(48, 64), big=(64, 96), wide=(64, 96, 16),
                        frames=1, devices=jax.devices()[:4])
    assert [r["mesh"] for r in res] == [dict(b=4), dict(y=2, x=2), dict(d=4)]
    for r in res:
        worst = max(max(m.values()) for m in r["mismatches"])
        assert worst <= r["mismatch_bound"]


def test_phase_four_needs_four_devices():
    import jax

    with pytest.raises(AssertionError, match="needs 4 devices"):
        cs.phase_four(devices=jax.devices()[:2])

