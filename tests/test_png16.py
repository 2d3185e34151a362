"""16-bit PNG support in both codecs (VERDICT round-1 Missing #2).

The reference's stb_image.h reads 16-bit PNGs (its PNG16 path); the
framework needs them for the --gt workflow (Middlebury-style ground
truth stores scaled disparities as 16-bit gray).
"""

import struct
import zlib

import numpy as np
import pytest

from stereo_matching.utils import io, png as pypng

needs_native = pytest.mark.skipif(
    not io.native_available(), reason="native stereoio not built")


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload) & 0xFFFFFFFF))


def _make_png16(img: np.ndarray, filters: list[int]) -> bytes:
    """Hand-build a 16-bit gray PNG with a chosen filter per scanline
    (exercises the bpp=2 defilter paths)."""
    h, w = img.shape
    be = img.astype(">u2").view(np.uint8).reshape(h, w * 2)
    raw = bytearray()
    prev = np.zeros(w * 2, dtype=np.int32)
    for y in range(h):
        line = be[y].astype(np.int32)
        f = filters[y % len(filters)]
        raw.append(f)
        enc = np.empty(w * 2, dtype=np.int32)
        for x in range(w * 2):
            a = line[x - 2] if x >= 2 else 0
            b = prev[x]
            c = prev[x - 2] if x >= 2 else 0
            if f == 0:
                pred = 0
            elif f == 1:
                pred = a
            elif f == 2:
                pred = b
            elif f == 3:
                pred = (a + b) >> 1
            else:  # Paeth
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            enc[x] = (line[x] - pred) & 0xFF
        raw.extend(enc.astype(np.uint8).tobytes())
        prev = line
    ihdr = struct.pack(">IIBBBBB", w, h, 16, 0, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(bytes(raw), 6))
            + _chunk(b"IEND", b""))


@pytest.fixture
def gray16(rng):
    return rng.integers(0, 65536, size=(23, 41), dtype=np.uint16)


def test_python_roundtrip_gray16(tmp_path, gray16):
    p = str(tmp_path / "g16.png")
    pypng.write_png(p, gray16)
    back = pypng.read_png(p)
    assert back.dtype == np.uint16
    np.testing.assert_array_equal(back, gray16)


def test_python_roundtrip_rgb16(tmp_path, rng):
    img = rng.integers(0, 65536, size=(9, 13, 3), dtype=np.uint16)
    p = str(tmp_path / "rgb16.png")
    pypng.write_png(p, img)
    back = pypng.read_png(p)
    assert back.dtype == np.uint16
    np.testing.assert_array_equal(back, img)


def test_python_reads_all_filters_16bit(tmp_path, gray16):
    p = str(tmp_path / "filt16.png")
    with open(p, "wb") as f:
        f.write(_make_png16(gray16, filters=[0, 1, 2, 3, 4]))
    np.testing.assert_array_equal(pypng.read_png(p), gray16)


@needs_native
def test_native_reads_all_filters_16bit(tmp_path, gray16):
    p = str(tmp_path / "filt16.png")
    with open(p, "wb") as f:
        f.write(_make_png16(gray16, filters=[4, 3, 2, 1, 0]))
    back = io.read_png(p)
    assert back.dtype == np.uint16
    np.testing.assert_array_equal(back, gray16)


@needs_native
def test_native_roundtrip_gray16(tmp_path, gray16):
    p = str(tmp_path / "n16.png")
    io.write_png(p, gray16)  # dispatches to sio_write_png16
    back = io.read_png(p)
    assert back.dtype == np.uint16
    np.testing.assert_array_equal(back, gray16)
    # and the python reader agrees on the native writer's output
    np.testing.assert_array_equal(pypng.read_png(p), gray16)


def test_cross_codec_16bit(tmp_path, gray16):
    """Python writer → native reader (when built)."""
    p = str(tmp_path / "x16.png")
    pypng.write_png(p, gray16)
    np.testing.assert_array_equal(io.read_png(p), gray16)


def test_malformed_chunk_length_rejected(tmp_path):
    """A declared chunk length far beyond the file must error cleanly
    (no 4 GiB allocation, no abort across the ctypes boundary)."""
    ihdr = struct.pack(">IIBBBBB", 4, 4, 8, 0, 0, 0, 0)
    data = (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + struct.pack(">I", 0x7FFFFFF0) + b"IDAT" + b"\x00" * 16)
    p = str(tmp_path / "evil.png")
    with open(p, "wb") as f:
        f.write(data)
    with pytest.raises(Exception):
        io.read_png(p)


def test_gt_workflow_16bit(tmp_path, rng):
    """CLI --gt on a 16-bit GT PNG (scaled disparities)."""
    from stereo_matching.metrics import bad_pixel_rate

    gt_disp = rng.integers(0, 16, size=(16, 20)).astype(np.float32)
    p = str(tmp_path / "gt16.png")
    io.write_png(p, (gt_disp * 256.0).astype(np.uint16))
    back = io.read_png(p).astype(np.float32) / 256.0
    np.testing.assert_array_equal(back, gt_disp)
    assert bad_pixel_rate(gt_disp, back, 2.0) == 0.0
