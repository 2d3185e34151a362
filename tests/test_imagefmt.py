"""Decode-surface tests: Adam7-interlaced PNG, BMP, TGA (the wider
stb_image.h read surface — SURVEY.md component #12 tail)."""

import struct
import zlib

import numpy as np
import pytest

from stereo_matching.utils import imagefmt, png as pypng
from stereo_matching.utils.io import read_image

RNG = np.random.default_rng(11)


# ----------------------------------------------------- Adam7 PNG

def _encode_adam7(img: np.ndarray) -> bytes:
    """Independent Adam7 encoder (filter 0 everywhere) — written from
    the PNG spec, so a decoder bug can't cancel out."""
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    passes = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
              (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)]
    raw = bytearray()
    for x0, y0, dx, dy in passes:
        sub = img[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        for row in sub:
            raw.append(0)               # filter type 0
            raw.extend(row.tobytes())

    def chunk(ctype, payload):
        data = ctype + payload
        return struct.pack(">I", len(payload)) + data + struct.pack(
            ">I", zlib.crc32(data))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 1)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("shape", [(13, 17, 3), (8, 8, 1), (1, 1, 1),
                                   (3, 40, 4), (33, 5, 2)])
def test_adam7_roundtrip(tmp_path, shape):
    img = RNG.integers(0, 256, shape, dtype=np.uint8)
    p = tmp_path / "i.png"
    p.write_bytes(_encode_adam7(img))
    got = pypng.read_png(str(p))
    want = img[..., 0] if shape[2] == 1 else img
    np.testing.assert_array_equal(got, want)


def test_adam7_matches_sequential(tmp_path):
    """The same pixels encoded interlaced and sequential must decode
    identically (sequential path = our own writer)."""
    img = RNG.integers(0, 256, (21, 19, 3), dtype=np.uint8)
    pi = tmp_path / "i.png"
    ps = tmp_path / "s.png"
    pi.write_bytes(_encode_adam7(img))
    pypng.write_png(str(ps), img)
    np.testing.assert_array_equal(pypng.read_png(str(pi)),
                                  pypng.read_png(str(ps)))


def test_adam7_through_read_image(tmp_path):
    """io.read_image (native codec first) must fall back to the Python
    codec for interlaced files and return the pixels."""
    img = RNG.integers(0, 256, (12, 11, 3), dtype=np.uint8)
    p = tmp_path / "i.png"
    p.write_bytes(_encode_adam7(img))
    np.testing.assert_array_equal(read_image(str(p)), img)


def test_adam7_truncated_rejected(tmp_path):
    img = RNG.integers(0, 256, (16, 16, 3), dtype=np.uint8)
    data = _encode_adam7(img)
    # re-compress a truncated stream so zlib succeeds but passes are short
    full = zlib.decompress(
        data[data.index(b"IDAT") + 4 : data.rindex(b"IEND") - 8])
    short = zlib.compress(full[: len(full) // 2])

    def chunk(ctype, payload):
        d = ctype + payload
        return struct.pack(">I", len(payload)) + d + struct.pack(
            ">I", zlib.crc32(d))

    ihdr = struct.pack(">IIBBBBB", 16, 16, 8, 2, 0, 0, 1)
    p = tmp_path / "bad.png"
    p.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                  + chunk(b"IDAT", short) + chunk(b"IEND", b""))
    with pytest.raises(ValueError):
        pypng.read_png(str(p))


# ----------------------------------------------------- BMP

@pytest.mark.parametrize("shape", [(7, 5, 3), (16, 16, 3), (9, 13)])
def test_bmp_roundtrip(tmp_path, shape):
    img = RNG.integers(0, 256, shape, dtype=np.uint8)
    p = tmp_path / "x.bmp"
    imagefmt.write_bmp(str(p), img)
    got = read_image(str(p))
    want = np.repeat(img[..., None], 3, 2) if img.ndim == 2 else img
    np.testing.assert_array_equal(got, want)


def test_bmp_8bit_palette_and_topdown(tmp_path):
    """Hand-built 8-bit gray-palette top-down BMP decodes to (H, W)."""
    h, w = 4, 6
    idx = RNG.integers(0, 256, (h, w), dtype=np.uint8)
    stride = (w + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w] = idx
    palette = bytes(v for i in range(256) for v in (i, i, i, 0))  # BGRA
    pix_off = 54 + 1024
    header = struct.pack("<2sIHHI", b"BM", pix_off + rows.size, 0, 0, pix_off)
    dib = struct.pack("<IiiHHIIiiII", 40, w, -h, 1, 8, 0, rows.size,
                      0, 0, 256, 0)
    p = tmp_path / "pal.bmp"
    p.write_bytes(header + dib + palette + rows.tobytes())
    np.testing.assert_array_equal(imagefmt.read_bmp(str(p)), idx)


def test_bmp_32bit(tmp_path):
    """Hand-built 32-bit BGRA bottom-up BMP → RGBA."""
    h, w = 3, 2
    rgba = RNG.integers(0, 256, (h, w, 4), dtype=np.uint8)
    bgra = rgba[::-1][:, :, [2, 1, 0, 3]]
    header = struct.pack("<2sIHHI", b"BM", 54 + bgra.size, 0, 0, 54)
    dib = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 32, 0, bgra.size,
                      0, 0, 0, 0)
    p = tmp_path / "x32.bmp"
    p.write_bytes(header + dib + bgra.tobytes())
    np.testing.assert_array_equal(imagefmt.read_bmp(str(p)), rgba)


def test_bmp_compressed_rejected(tmp_path):
    header = struct.pack("<2sIHHI", b"BM", 100, 0, 0, 54)
    dib = struct.pack("<IiiHHIIiiII", 40, 2, 2, 1, 24, 1, 0, 0, 0, 0, 0)
    p = tmp_path / "rle.bmp"
    p.write_bytes(header + dib + b"\0" * 16)
    with pytest.raises(NotImplementedError):
        imagefmt.read_bmp(str(p))


# ----------------------------------------------------- TGA

@pytest.mark.parametrize("shape", [(7, 5, 3), (9, 13)])
def test_tga_roundtrip(tmp_path, shape):
    img = RNG.integers(0, 256, shape, dtype=np.uint8)
    p = tmp_path / "x.tga"
    imagefmt.write_tga(str(p), img)
    np.testing.assert_array_equal(read_image(str(p)), img)


def test_tga_rle_and_bottom_up(tmp_path):
    """Hand-built RLE truecolor bottom-up TGA: a run packet + literal
    packet per row."""
    w, h = 5, 2
    img = np.zeros((h, w, 3), np.uint8)
    img[0, :3] = [10, 20, 30]      # top row: run of 3 + 2 literals
    img[0, 3] = [1, 2, 3]
    img[0, 4] = [4, 5, 6]
    img[1, :] = [200, 100, 50]     # bottom row: run of 5
    header = struct.pack("<BBBHHBHHHHBB", 0, 0, 10, 0, 0, 0, 0, 0,
                         w, h, 24, 0)          # bit5=0: bottom-up
    body = bytearray()
    # file stores bottom row first
    body += bytes([0x80 | 4]) + bytes([50, 100, 200])          # run 5 (BGR)
    body += bytes([0x80 | 2]) + bytes([30, 20, 10])            # run 3
    body += bytes([1]) + bytes([3, 2, 1]) + bytes([6, 5, 4])   # 2 literals
    p = tmp_path / "rle.tga"
    p.write_bytes(header + bytes(body))
    np.testing.assert_array_equal(imagefmt.read_tga(str(p)), img)


def test_tga_rle_gray(tmp_path):
    w, h = 4, 1
    header = struct.pack("<BBBHHBHHHHBB", 0, 0, 11, 0, 0, 0, 0, 0,
                         w, h, 8, 0x20)
    body = bytes([0x80 | 1, 77, 1, 5, 9])      # run of 2 + 2 literals
    p = tmp_path / "g.tga"
    p.write_bytes(header + body)
    np.testing.assert_array_equal(imagefmt.read_tga(str(p)),
                                  np.array([[77, 77, 5, 9]], np.uint8))


@pytest.mark.parametrize("packet", [
    bytes([0x80 | 5, 77]),                # run of 6 into a 4-px image
    bytes([5, 1, 2, 3, 4, 5, 6]),         # 6 literals into a 4-px image
])
def test_tga_rle_overrun_message(tmp_path, packet):
    """Overruning RLE packets (run AND literal) must raise the
    path-labeled error, not a raw numpy broadcast error (ADVICE r3)."""
    w, h = 4, 1
    header = struct.pack("<BBBHHBHHHHBB", 0, 0, 11, 0, 0, 0, 0, 0,
                         w, h, 8, 0x20)
    p = tmp_path / "over.tga"
    p.write_bytes(header + packet)
    with pytest.raises(ValueError, match="TGA RLE overruns"):
        imagefmt.read_tga(str(p))


def test_bmp_pair_through_cli(tmp_path):
    """End-to-end: a BMP stereo pair through the CLI produces the same
    disparity as the same pixels via PNG."""
    import subprocess
    import sys
    import os

    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, (40, 72 + 8, 3), dtype=np.uint8)
    left, right = base[:, 8:], base[:, :-8]
    for ext, writer in [("bmp", imagefmt.write_bmp), ("png", pypng.write_png)]:
        writer(str(tmp_path / f"l.{ext}"), left)
        writer(str(tmp_path / f"r.{ext}"), right)
        out = tmp_path / f"out_{ext}"
        r = subprocess.run(
            [sys.executable, "-m", "stereo_matching",
             str(tmp_path / f"l.{ext}"), str(tmp_path / f"r.{ext}"),
             "-o", str(out), "--d-min", "-7", "--d-max", "0"],
            capture_output=True, text=True, env=dict(os.environ), timeout=600)
        assert r.returncode == 0, r.stderr[-1500:]
    a = pypng.read_png(str(tmp_path / "out_bmp" / "disparity_mapl.png"))
    b = pypng.read_png(str(tmp_path / "out_png" / "disparity_mapl.png"))
    np.testing.assert_array_equal(a, b)


def test_corrupt_files_raise_valueerror(tmp_path):
    """The codec error contract (review r5): malformed binary files
    must raise ValueError, not IndexError/struct.error — the CLI and
    serve map ValueError to clean diagnostics."""
    import pytest

    from stereo_matching.utils.imagefmt import read_bmp
    from stereo_matching.utils.legacyfmt import read_gif

    short_bmp = tmp_path / "short.bmp"
    short_bmp.write_bytes(b"BM\x00\x00")          # 4-byte header
    with pytest.raises(ValueError, match="corrupt BMP"):
        read_bmp(str(short_bmp))

    trunc_gif = tmp_path / "trunc.gif"
    trunc_gif.write_bytes(b"GIF89a\x02\x00\x02\x00\x80\x00\x00"
                          b"\x00\x00\x00\xff\xff\xff\x2c")
    with pytest.raises(ValueError, match="corrupt GIF|GIF"):
        read_gif(str(trunc_gif))
