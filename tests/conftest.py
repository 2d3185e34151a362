"""Test environment: force CPU with 8 virtual devices so sharding tests
run without accelerator hardware (SURVEY.md §4 translation note).

Must run before any jax import — pytest imports conftest first.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    _flags += " --xla_force_host_platform_device_count=8"
# fast-math off: not needed for correctness (strict_mul guards the
# FMA-sensitive spots) but compiles the sequential-scan parity graphs
# ~30x faster on CPU.
if "xla_cpu_enable_fast_math" not in _flags:
    _flags += " --xla_cpu_enable_fast_math=false"
os.environ["XLA_FLAGS"] = _flags.strip()

import jax

# The jaxtyping pytest plugin imports jax BEFORE this conftest runs, so
# the JAX_PLATFORMS env var above can come too late; config.update works
# any time before first backend initialization.
jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

REFERENCE_DATA = "/root/reference/stereo_matching_cuda/data"


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_between_modules():
    """Drop compiled executables after each test module.

    XLA:CPU aborts/segfaults nondeterministically inside a LATER
    module's compile once enough jitted executables from earlier
    modules accumulate in the process (reproduced deterministically
    with a few compile-heavy modules in one worker; the crash lands in
    backend_compile_and_load with no Python frames of ours on the
    stack — a compiler resource bug, not a semantics issue).  Clearing
    the caches at module boundaries keeps per-module compile sets
    bounded; shared fixtures are plain numpy, so nothing breaks."""
    yield
    jax.clear_caches()


def _has_reference() -> bool:
    return os.path.isdir(REFERENCE_DATA)


requires_reference = pytest.mark.skipif(
    not _has_reference(), reason="reference repo not mounted at /root/reference"
)


@pytest.fixture(scope="session")
def tsukuba():
    """(left, right) uint8 RGB Tsukuba pair from the reference data dir,
    or, when that is not mounted, a seeded Tsukuba-shaped (288 x 384,
    16-disparity) synthetic scene (utils/synth.make_scene)."""
    if not _has_reference():
        from stereo_matching.utils.synth import make_scene

        s = make_scene(288, 384, ndisp=16, seed=11)
        return s["left"], s["right"]
    from stereo_matching.utils.png import read_png

    left = read_png(os.path.join(REFERENCE_DATA, "tsukuba0.png"))
    right = read_png(os.path.join(REFERENCE_DATA, "tsukuba1.png"))
    return left, right


@pytest.fixture()
def rng():
    # function-scoped: every test sees the same stream regardless of
    # execution order
    return np.random.default_rng(1234)


@pytest.fixture(scope="session")
def small_pair():
    """Small random RGB pair with correlated structure (a shifted copy
    plus noise) so disparity estimation is non-degenerate."""
    rng = np.random.default_rng(99)
    h, w = 48, 64
    base = rng.integers(0, 256, size=(h, w + 24, 3), dtype=np.uint8)
    left = base[:, 12 : 12 + w]
    right_f = base[:, 8 : 8 + w].astype(np.int32) + rng.integers(-6, 7, size=(h, w, 3))
    right = np.clip(right_f, 0, 255).astype(np.uint8)
    return left, right
