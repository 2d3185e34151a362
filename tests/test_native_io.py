"""Native C++ codec (native/stereoio) vs the pure-Python codec and the
write_mat oracle.  Skips when no toolchain/so is available."""

import os

import numpy as np
import pytest

from stereo_matching.utils import io, png as pypng
from stereo_matching import reference as R

from conftest import REFERENCE_DATA, requires_reference

pytestmark = pytest.mark.skipif(
    not io.native_available(), reason="native stereoio not built"
)


@requires_reference
def test_native_reader_matches_python_on_reference_pngs():
    for f in sorted(os.listdir(REFERENCE_DATA)):
        if not f.endswith(".png"):
            continue
        a = io.read_png(os.path.join(REFERENCE_DATA, f))
        b = pypng.read_png(os.path.join(REFERENCE_DATA, f))
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("shape", [(37, 53), (20, 30, 3), (8, 9, 4), (1, 1), (2, 500, 3)])
def test_native_roundtrip(tmp_path, rng, shape):
    img = rng.integers(0, 256, size=shape, dtype=np.uint8)
    p = str(tmp_path / "rt.png")
    io.write_png(p, img)
    back = io.read_png(p)
    np.testing.assert_array_equal(back, img)
    # and the python reader agrees on the native writer's output
    np.testing.assert_array_equal(pypng.read_png(p), img)


def test_native_write_mat_normalize_matches_oracle(rng):
    for _ in range(10):
        m = rng.normal(0, 100, size=(64, 80)).astype(np.float32)
        np.testing.assert_array_equal(io.write_mat_normalize(m), R.write_mat_normalize(m))


def test_native_write_mat_normalize_extremes():
    m = np.array([[3.39e38, -115.0, 0.0, -15.0]], dtype=np.float32)
    np.testing.assert_array_equal(io.write_mat_normalize(m), R.write_mat_normalize(m))


def test_native_read_missing_file_falls_back_cleanly(tmp_path):
    with pytest.raises(Exception):
        io.read_png(str(tmp_path / "nope.png"))


def test_write_mat_normalize_constant_input():
    """Constant input hits the reference expression's divide-by-zero;
    the defined contract is all-zeros in BOTH the NumPy oracle and the
    native codec (review r5: the C cast of NaN was UB)."""
    import numpy as np

    from stereo_matching import reference as R
    from stereo_matching.utils.io import write_mat_normalize

    const = np.full((6, 8), 3.25, np.float32)
    np.testing.assert_array_equal(R.write_mat_normalize(const),
                                  np.zeros((6, 8), np.uint8))
    np.testing.assert_array_equal(write_mat_normalize(const),
                                  np.zeros((6, 8), np.uint8))
