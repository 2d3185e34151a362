"""GIF/PSD/PIC readers, HDR codec and the JPEG writer — the tail of
the stb_image / stb_image_write format surface (SURVEY.md §2.2 #12).
GIF fixtures are produced by PIL (a real encoder); PSD/PIC fixtures
are hand-assembled per spec; HDR and JPEG round-trip through our own
codecs with PIL cross-checks where PIL supports the format."""

import struct

import numpy as np
import pytest

from stereo_matching.utils import imagefmt, jpeg, legacyfmt
from stereo_matching.utils.io import read_image

try:
    from PIL import Image

    HAVE_PIL = True
except ImportError:
    HAVE_PIL = False


def _rgb(h, w, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)


# ----------------------------------------------------------------- GIF

@pytest.mark.skipif(not HAVE_PIL, reason="PIL needed to encode GIF")
def test_gif_pil_roundtrip(tmp_path):
    img = _rgb(21, 33, seed=3)
    p = str(tmp_path / "t.gif")
    Image.fromarray(img).save(p)          # palettized by PIL (<=256 colors)
    ours = legacyfmt.read_gif(p)
    theirs = np.asarray(Image.open(p).convert("RGB"))
    np.testing.assert_array_equal(ours[..., :3], theirs)
    assert read_image(p).shape == ours.shape


@pytest.mark.skipif(not HAVE_PIL, reason="PIL needed to encode GIF")
def test_gif_interlaced_and_gray(tmp_path):
    gray = np.tile(np.arange(64, dtype=np.uint8) * 4, (17, 1))
    p = str(tmp_path / "i.gif")
    Image.fromarray(gray, "L").save(p, interlace=True)
    ours = legacyfmt.read_gif(p)
    theirs = np.asarray(Image.open(p).convert("RGB"))
    np.testing.assert_array_equal(ours[..., :3], theirs)


@pytest.mark.skipif(not HAVE_PIL, reason="PIL needed to encode GIF")
def test_gif_transparency(tmp_path):
    img = np.zeros((5, 7), np.uint8)
    img[2, 3] = 1
    pal = Image.fromarray(img, "P")
    pal.putpalette([10, 20, 30, 200, 100, 50] + [0] * (254 * 3))
    p = str(tmp_path / "t.gif")
    pal.save(p, transparency=0)
    out = legacyfmt.read_gif(p)
    assert out.shape == (5, 7, 4)
    assert out[2, 3, 3] == 255 and (out[2, 3, :3] == (200, 100, 50)).all()
    assert out[0, 0, 3] == 0


def test_gif_rejects_non_gif(tmp_path):
    p = tmp_path / "x.gif"
    p.write_bytes(b"NOTAGIF" * 4)
    with pytest.raises(ValueError, match="not a GIF"):
        legacyfmt.read_gif(str(p))


# ----------------------------------------------------------------- PSD

def _psd_bytes(img: np.ndarray, compression: int) -> bytes:
    """Assemble a minimal PSD per spec: header + empty sections +
    composite image data (raw planar or PackBits RLE)."""
    if img.ndim == 2:
        channels, mode = 1, 1
        planes = img[None]
    else:
        channels, mode = img.shape[2], 3
        planes = img.transpose(2, 0, 1)
    h, w = img.shape[:2]
    depth = 16 if img.dtype == np.uint16 else 8
    out = bytearray()
    out += b"8BPS" + struct.pack(">H", 1) + b"\x00" * 6
    out += struct.pack(">HIIHH", channels, h, w, depth, mode)
    out += struct.pack(">I", 0) * 3               # color data/resources/layers
    out += struct.pack(">H", compression)
    if compression == 0:
        for p in planes:
            out += p.astype(">u2" if depth == 16 else np.uint8).tobytes()
    else:                                         # naive PackBits: literals
        rows = []
        for p in planes:
            for y in range(h):
                row = bytearray()
                x = 0
                line = p[y]
                while x < w:
                    n = min(128, w - x)
                    row += bytes([n - 1]) + line[x : x + n].astype(
                        np.uint8).tobytes()
                    x += n
                rows.append(bytes(row))
        out += b"".join(struct.pack(">H", len(r)) for r in rows)
        out += b"".join(rows)
    return bytes(out)


def test_psd_raw_rgb(tmp_path):
    img = _rgb(9, 14, seed=5)
    p = tmp_path / "t.psd"
    p.write_bytes(_psd_bytes(img, compression=0))
    np.testing.assert_array_equal(legacyfmt.read_psd(str(p)), img)
    np.testing.assert_array_equal(read_image(str(p)), img)
    if HAVE_PIL:
        theirs = np.asarray(Image.open(str(p)).convert("RGB"))
        np.testing.assert_array_equal(theirs, img)


def test_psd_rle_gray_and_16bit(tmp_path):
    gray = np.arange(11 * 13, dtype=np.uint32).reshape(11, 13).astype(np.uint8)
    p = tmp_path / "g.psd"
    p.write_bytes(_psd_bytes(gray, compression=1))
    np.testing.assert_array_equal(legacyfmt.read_psd(str(p)), gray)
    img16 = (_rgb(6, 8, seed=7).astype(np.uint16) * 257)
    p2 = tmp_path / "w.psd"
    p2.write_bytes(_psd_bytes(img16, compression=0))
    out = legacyfmt.read_psd(str(p2))
    assert out.dtype == np.uint16
    np.testing.assert_array_equal(out, img16)


def test_psd_run_packets(tmp_path):
    """PackBits run packets (257-n copies) through a hand-built row."""
    h, w = 2, 10
    out = bytearray()
    out += b"8BPS" + struct.pack(">H", 1) + b"\x00" * 6
    out += struct.pack(">HIIHH", 1, h, w, 8, 1)
    out += struct.pack(">I", 0) * 3
    out += struct.pack(">H", 1)
    row1 = bytes([0xF7, 42])                                 # 257-247 = 10-run of 42
    row2 = bytes([4, 1, 2, 3, 4, 5, 0xFC, 9])                # 5 lit + 5-run
    out += struct.pack(">HH", len(row1), len(row2)) + row1 + row2
    p = tmp_path / "r.psd"
    p.write_bytes(bytes(out))
    got = legacyfmt.read_psd(str(p))
    np.testing.assert_array_equal(got[0], np.full(10, 42, np.uint8))
    np.testing.assert_array_equal(
        got[1], np.array([1, 2, 3, 4, 5, 9, 9, 9, 9, 9], np.uint8))


# ----------------------------------------------------------------- PIC

def _pic_bytes(img: np.ndarray, rle: bool) -> bytes:
    h, w = img.shape[:2]
    nc = img.shape[2]
    out = bytearray()
    out += b"\x53\x80\xf6\x34" + struct.pack(">f", 3.71) + b"\x00" * 80
    out += b"PICT" + struct.pack(">HHfHH", w, h, 1.0, 3, 0)
    mask = 0xE0 if nc == 3 else 0xF0              # RGB / RGBA
    out += bytes([0, 8, 2 if rle else 0, mask])   # single unchained packet
    for y in range(h):
        row = img[y]
        if not rle:
            out += row.tobytes()
        else:
            x = 0
            while x < w:
                run = 1
                while (x + run < w and run < 127
                       and (row[x + run] == row[x]).all()):
                    run += 1
                if run >= 2:
                    out += bytes([127 + run]) + row[x].tobytes()
                    x += run
                else:
                    lit = x + 1
                    while (lit < w and lit - x < 128
                           and (lit + 1 >= w
                                or not (row[lit] == row[lit - 1]).all())):
                        lit += 1
                    out += bytes([lit - x - 1]) + row[x:lit].tobytes()
                    x = lit
    return bytes(out)


@pytest.mark.parametrize("rle", [False, True])
def test_pic_roundtrip(tmp_path, rle):
    img = _rgb(7, 19, seed=11)
    img[2, 4:15] = img[2, 4]                      # embed a run
    p = tmp_path / "t.pic"
    p.write_bytes(_pic_bytes(img, rle))
    np.testing.assert_array_equal(legacyfmt.read_pic(str(p)), img)
    np.testing.assert_array_equal(read_image(str(p)), img)


def test_pic_rgba_and_long_run(tmp_path):
    rgba = np.concatenate([_rgb(3, 300, seed=13),
                           np.full((3, 300, 1), 7, np.uint8)], axis=2)
    rgba[1] = rgba[1, 0]                          # 300-long run (>u8 count)
    h, w = 3, 300
    out = bytearray()
    out += b"\x53\x80\xf6\x34" + struct.pack(">f", 3.71) + b"\x00" * 80
    out += b"PICT" + struct.pack(">HHfHH", w, h, 1.0, 3, 0)
    out += bytes([0, 8, 2, 0xF0])
    for y in range(h):
        row = rgba[y]
        if y == 1:
            out += bytes([128]) + struct.pack(">H", w) + row[0].tobytes()
        else:
            x = 0
            while x < w:
                n = min(128, w - x)
                out += bytes([n - 1]) + row[x : x + n].tobytes()
                x += n
    p = tmp_path / "a.pic"
    p.write_bytes(bytes(out))
    got = legacyfmt.read_pic(str(p))
    assert got.shape == (3, 300, 4)
    np.testing.assert_array_equal(got, rgba)


# ----------------------------------------------------------------- HDR

def test_hdr_roundtrip(tmp_path):
    rng = np.random.default_rng(2)
    img = (rng.random((13, 37, 3)).astype(np.float32) * 4.0)
    img[3:6, 5:20] = 0.25                         # RLE runs
    img[7] = 0.0                                  # zero pixels
    p = str(tmp_path / "t.hdr")
    imagefmt.write_hdr(p, img)
    back = imagefmt.read_hdr(p)
    assert back.shape == img.shape and back.dtype == np.float32
    bound = img.max(axis=2, keepdims=True) / 128 + 1e-7
    assert (np.abs(back - img) <= bound).all()
    assert (back[7] == 0).all()
    assert read_image(p).shape == img.shape


def test_hdr_flat_narrow_and_errors(tmp_path):
    img = np.linspace(0, 2, 5 * 3 * 3, dtype=np.float32).reshape(5, 3, 3)
    p = str(tmp_path / "n.hdr")
    imagefmt.write_hdr(p, img)                    # w < 8 → flat scanlines
    back = imagefmt.read_hdr(p)
    bound = img.max(axis=2, keepdims=True) / 128 + 1e-7
    assert (np.abs(back - img) <= bound).all()
    bad = tmp_path / "bad.hdr"
    bad.write_bytes(b"not radiance")
    with pytest.raises(ValueError, match="not a Radiance"):
        imagefmt.read_hdr(str(bad))


@pytest.mark.skipif(not HAVE_PIL, reason="PIL cross-check")
def test_hdr_pil_cross_decode(tmp_path):
    img = np.abs(np.random.default_rng(3).normal(
        1.0, 0.5, (16, 24, 3))).astype(np.float32)
    p = str(tmp_path / "x.hdr")
    imagefmt.write_hdr(p, img)
    try:
        theirs = np.asarray(Image.open(p)).astype(np.float32)
    except Exception:
        pytest.skip("PIL lacks Radiance HDR decode")
    ours = imagefmt.read_hdr(p)
    assert np.allclose(theirs, ours, rtol=0.02, atol=1e-3)


# ---------------------------------------------------------------- JPEG

def _smooth(h, w):
    x = np.linspace(0, 6, w)
    y = np.linspace(0, 4, h)
    return (127 + 80 * np.sin(y[:, None]) * np.cos(x[None, :])
            + 40 * np.outer(np.cos(3 * y), np.sin(2 * x))).clip(
                0, 255).astype(np.uint8)


def test_jpeg_write_roundtrip_rgb():
    import tempfile, os

    g = _smooth(88, 120)
    rgb = np.stack([g, np.roll(g, 7, 1), 255 - g], -1)
    p = tempfile.mktemp(suffix=".jpg")
    try:
        jpeg.write_jpeg(p, rgb, quality=92)
        back = jpeg.read_jpeg(p)
        err = np.abs(back.astype(int) - rgb.astype(int))
        assert back.shape == rgb.shape and err.max() <= 12 and err.mean() < 2
    finally:
        os.remove(p)


def test_jpeg_write_roundtrip_gray_odd_size():
    import tempfile, os

    g = _smooth(37, 61)                           # non-multiple-of-8 dims
    p = tempfile.mktemp(suffix=".jpg")
    try:
        jpeg.write_jpeg(p, g, quality=95)
        back = jpeg.read_jpeg(p)
        assert back.shape == g.shape
        assert np.abs(back.astype(int) - g.astype(int)).max() <= 6
    finally:
        os.remove(p)


@pytest.mark.skipif(not HAVE_PIL, reason="PIL cross-check")
def test_jpeg_write_pil_decodes(tmp_path):
    g = _smooth(40, 56)
    rgb = np.stack([g, 255 - g, np.roll(g, 3, 0)], -1)
    p = str(tmp_path / "x.jpg")
    jpeg.write_jpeg(p, rgb, quality=90)
    theirs = np.asarray(Image.open(p).convert("RGB")).astype(int)
    ours = jpeg.read_jpeg(p).astype(int)
    assert np.abs(theirs - ours).max() <= 3       # two conformant IDCTs
    assert np.abs(theirs - rgb.astype(int)).max() <= 15


def test_jpeg_writer_rejects_bad_input(tmp_path):
    with pytest.raises(ValueError, match="uint8"):
        jpeg.write_jpeg(str(tmp_path / "b.jpg"), np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError, match="needs"):
        jpeg.write_jpeg(str(tmp_path / "b.jpg"),
                        np.zeros((4, 4, 2), np.uint8))
