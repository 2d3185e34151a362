"""Minimal dependency-free PNG codec (8/16-bit, sequential + Adam7).

The reference vendors stb_image / stb_image_write (single-header C
libraries) as its image I/O layer (SystemIncludes.h:3-5, main.cu:57-58,
162-181).  This module is the framework's pure-Python fallback; the
C++ native codec in ``native/stereoio`` (loaded via ctypes in
``stereo_matching.utils.io``) is the fast path.

Supports reading color types 0 (gray), 2 (RGB), 3 (palette, 8-bit
only), 4 (gray+A), 6 (RGBA) at bit depths 8 and 16 (the 16-bit path
mirrors stb_image.h's PNG16 support — Middlebury-style ground-truth
disparity files), sequential and Adam7-interlaced (stb_image.h's
full interlace surface), and writing uint8 gray / RGB / RGBA plus
uint16 gray / RGB.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .parse import codec_errors

_MAGIC = b"\x89PNG\r\n\x1a\n"


def _unfilter_lines(raw: np.ndarray, h: int, stride: int, bpp: int,
                    path: str) -> np.ndarray:
    """Undo the per-scanline PNG filters for ``h`` lines of ``stride``
    payload bytes each (raw holds h*(stride+1) bytes, filter byte
    first).  Shared by the sequential and Adam7 paths — each interlace
    pass is filtered as an independent sub-image (prev row resets)."""
    raw = raw.reshape(h, stride + 1)
    filters = raw[:, 0]
    lines = raw[:, 1:]
    out = np.zeros((h, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    for y in range(h):
        f = filters[y]
        line = lines[y].copy()
        if f == 0:
            cur = line
        elif f == 1:  # Sub
            cur = line
            for x in range(bpp, stride):
                cur[x] = (int(cur[x]) + int(cur[x - bpp])) & 0xFF
        elif f == 2:  # Up
            cur = (line.astype(np.int32) + prev.astype(np.int32)).astype(np.uint8)
        elif f == 3:  # Average
            cur = line
            for x in range(stride):
                left = int(cur[x - bpp]) if x >= bpp else 0
                cur[x] = (int(cur[x]) + ((left + int(prev[x])) >> 1)) & 0xFF
        elif f == 4:  # Paeth
            cur = line
            for x in range(stride):
                a = int(cur[x - bpp]) if x >= bpp else 0
                c = int(prev[x - bpp]) if x >= bpp else 0
                b = int(prev[x])
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[x] = (int(cur[x]) + pred) & 0xFF
        else:
            raise ValueError(f"{path}: unknown filter {f}")
        out[y] = cur
        prev = cur
    return out


# Adam7 pass grid: (x0, y0, dx, dy) per pass (PNG spec §8.2)
_ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)]


def _deinterlace_adam7(raw: bytes, h: int, w: int, bpp: int,
                       path: str) -> np.ndarray:
    """Reassemble the 7 Adam7 passes (each an independently filtered
    sub-image, empty passes omitted) into (h, w, bpp) bytes."""
    full = np.zeros((h, w, bpp), dtype=np.uint8)
    buf = np.frombuffer(raw, dtype=np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw = (w - x0 + dx - 1) // dx
        ph = (h - y0 + dy - 1) // dy
        if pw <= 0 or ph <= 0:
            continue
        stride = pw * bpp
        need = ph * (stride + 1)
        if pos + need > len(buf):
            raise ValueError(f"{path}: truncated Adam7 pass data")
        sub = _unfilter_lines(buf[pos : pos + need], ph, stride, bpp, path)
        pos += need
        full[y0::dy, x0::dx] = sub.reshape(ph, pw, bpp)
    if pos != len(buf):
        raise ValueError(f"{path}: bad Adam7 IDAT size {len(buf)} != {pos}")
    return full


@codec_errors("PNG")
def read_png(path: str) -> np.ndarray:
    """Returns uint8 array of shape (H, W) for grayscale or (H, W, C)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _MAGIC:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    idat = bytearray()
    palette = None
    trns = None
    w = h = bitdepth = color_type = interlace = None
    while pos + 8 <= len(data):   # truncated trailing chunk: stop
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        chunk = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            w, h, bitdepth, color_type, _, _, interlace = struct.unpack(">IIBBBBB", chunk)
        elif ctype == b"PLTE":
            palette = np.frombuffer(chunk, dtype=np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = np.frombuffer(chunk, dtype=np.uint8)
        elif ctype == b"IDAT":
            idat.extend(chunk)
        elif ctype == b"IEND":
            break
    if w is None:
        raise ValueError(f"{path}: missing IHDR")
    if bitdepth not in (8, 16):
        raise NotImplementedError(
            f"{path}: bit depth {bitdepth} unsupported (8/16 only)")
    if bitdepth == 16 and color_type == 3:
        raise ValueError(f"{path}: 16-bit palette PNG is invalid")
    if interlace not in (0, 1):
        raise ValueError(f"{path}: unknown interlace method {interlace}")
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    try:
        raw = zlib.decompress(bytes(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG data ({e})") from e
    bpp = channels * (bitdepth // 8)  # filter offset in bytes
    stride = w * bpp
    if interlace == 0:
        expected = h * (stride + 1)
        if len(raw) != expected:
            raise ValueError(f"{path}: bad IDAT size {len(raw)} != {expected}")
        out = _unfilter_lines(
            np.frombuffer(raw, dtype=np.uint8), h, stride, bpp, path)
    else:
        out = _deinterlace_adam7(raw, h, w, bpp, path).reshape(h, stride)

    if bitdepth == 16:
        # big-endian sample pairs → host uint16
        pairs = out.reshape(h, w, channels, 2).astype(np.uint16)
        img = (pairs[..., 0] << 8) | pairs[..., 1]
        return img[..., 0] if channels == 1 else img
    img = out.reshape(h, w, channels)
    if color_type == 3:
        if palette is None:
            raise ValueError(f"{path}: palette image without PLTE")
        rgb = palette[img[..., 0]]
        if trns is not None:
            # tRNS may cover only the first palette entries (spec);
            # clip BEFORE indexing (np.where evaluates both branches)
            idx = img[..., 0]
            safe = trns[np.minimum(idx, len(trns) - 1)]
            a = np.full((h, w, 1), 255, dtype=np.uint8)
            a[..., 0] = np.where(idx < len(trns), safe, 255)
            return np.concatenate([rgb, a], axis=-1)
        return rgb
    if channels == 1:
        return img[..., 0]
    return img


def write_png(path: str, img: np.ndarray) -> None:
    """Writes uint8 (H,W) gray, (H,W,3) RGB, (H,W,4) RGBA; uint16
    arrays are written as 16-bit PNGs (gray or RGB)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(
            f"write_png needs uint8 or uint16 input, got {img.dtype} "
            "(normalize/convert explicitly — silent modulo-256 wrapping "
            "corrupts float maps)")
    bitdepth = 16 if img.dtype == np.uint16 else 8
    if img.ndim == 2:
        color_type, channels = 0, 1
        img = img[..., None]
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type, channels = 2, 3
    elif img.ndim == 3 and img.shape[2] == 4:
        color_type, channels = 6, 4
    else:
        raise ValueError(f"unsupported image shape {img.shape}")
    if bitdepth == 16 and color_type == 6:
        raise ValueError("16-bit RGBA write unsupported (gray/RGB only)")
    h, w = img.shape[:2]
    if bitdepth == 16:
        flat = img.astype(">u2").view(np.uint8).reshape(h, w * channels * 2)
    else:
        flat = img.reshape(h, w * channels)
    raw = np.zeros((h, flat.shape[1] + 1), dtype=np.uint8)
    raw[:, 1:] = flat  # filter type 0 per scanline
    compressed = zlib.compress(raw.tobytes(), 6)

    def chunk(ctype: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + ctype
            + payload
            + struct.pack(">I", zlib.crc32(ctype + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, bitdepth, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", compressed))
        f.write(chunk(b"IEND", b""))
