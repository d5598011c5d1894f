"""8-bit grayscale PNG codec.

The writer (stdlib zlib + struct + numpy) emits filter type 0 rows in one
IDAT chunk: the workdirs' PNGs (grey) and the flow renders (RGB).  The reader takes non-interlaced 8-bit
grayscale images with any of the five row filters; it checks the header
and decodes through OpenCV's libpng, which releases the interpreter lock
(io/image.py has the other formats).  decode_gray_plain is the codec's
own numpy decoder, the tests' reference.
"""

from __future__ import annotations

import struct
import zlib

import cv2
import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def _encode(img: np.ndarray, colour_type: int) -> bytes:
    H, W = img.shape[:2]
    row = img.reshape(H, -1)
    raw = np.empty((H, row.shape[1] + 1), np.uint8)
    raw[:, 0] = 0  # filter type 0 (None) on every row
    raw[:, 1:] = row
    ihdr = struct.pack(">IIBBBBB", W, H, 8, colour_type, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + _chunk(b"IEND", b""))


def encode_gray(img: np.ndarray) -> bytes:
    """PNG bytes of an (H, W) uint8 image."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 2:
        raise ValueError(f"expected an (H, W) image, got shape {img.shape}")
    return _encode(img, 0)


def encode_rgb(img: np.ndarray) -> bytes:
    """PNG bytes of an (H, W, 3) uint8 image in R, G, B order (colour type 2,
    the debug renders that must stay lossless)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got shape {img.shape}")
    return _encode(img, 2)


def _paeth(a, b, c):
    """The Paeth predictor (works on ints and on numpy arrays)."""
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(data: bytes, H: int, W: int) -> np.ndarray:
    """Undo the per-row filters of one-byte-per-pixel scanlines."""
    rows = np.frombuffer(data, np.uint8).reshape(H, W + 1)
    ftype, filt = rows[:, 0], rows[:, 1:]
    if (ftype > 4).any():
        y = int(np.flatnonzero(ftype > 4)[0])
        raise ValueError(f"bad PNG filter type {ftype[y]} in row {y}")
    if not (ftype >= 2).any():
        # None / Sub only (the port's writer: None): rows are independent,
        # so the whole image is a copy and one cumulative sum (uint8 wraps).
        out = filt.copy()
        sub = ftype == 1
        if sub.any():
            out[sub] = np.cumsum(filt[sub], axis=1, dtype=np.uint8)
        return out
    if not (ftype >= 3).any():
        # None / Sub / Up: each row is one vector operation (uint8 wraps).
        out = np.empty((H, W), np.uint8)
        prev = np.zeros(W, np.uint8)
        for y in range(H):
            if ftype[y] == 1:
                out[y] = np.cumsum(filt[y], dtype=np.uint8)
            elif ftype[y] == 2:
                out[y] = filt[y] + prev
            else:
                out[y] = filt[y]
            prev = out[y]
        return out
    # Average / Paeth rows depend on the left, upper and upper-left
    # neighbours, so pixels are reconstructed one anti-diagonal at a time.
    rec = np.zeros((H + 1, W + 1), np.int32)  # row 0 and column 0: the zero border
    f, t = filt.astype(np.int32), ftype.astype(np.int32)
    for k in range(H + W - 1):
        y = np.arange(max(0, k - W + 1), min(H, k + 1))
        x = k - y
        a, b, c = rec[y + 1, x], rec[y, x + 1], rec[y, x]
        pred = np.choose(t[y], [np.zeros_like(a), a, b, (a + b) >> 1, _paeth(a, b, c)])
        rec[y + 1, x + 1] = (f[y, x] + pred) & 0xFF
    return rec[1:, 1:].astype(np.uint8)


def gray_shape(buf: bytes) -> tuple:
    """(H, W) of PNG bytes that decode_gray reads (8-bit grayscale, not
    interlaced), from the IHDR chunk alone; raises ValueError otherwise."""
    if buf[:8] != _SIGNATURE or buf[12:16] != b"IHDR":
        raise ValueError("not a PNG file")
    W, H, depth, ctype, _comp, _filt, interlace = struct.unpack(">IIBBBBB", buf[16:29])
    if depth != 8 or ctype != 0 or interlace != 0:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {ctype}, interlace {interlace}")
    return H, W


def decode_gray(buf: bytes) -> np.ndarray:
    """(H, W) uint8 gray image from PNG bytes, decoded by OpenCV."""
    H, W = gray_shape(buf)
    img = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_UNCHANGED)
    if img is None or img.shape != (H, W):
        raise ValueError("corrupt PNG image data")
    return img


def decode_gray_plain(buf: bytes) -> np.ndarray:
    """(H, W) uint8 gray image from PNG bytes, by the codec's numpy unfilter."""
    if buf[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    idat = []
    header = None
    while pos < len(buf):
        (n,) = struct.unpack(">I", buf[pos : pos + 4])
        kind = buf[pos + 4 : pos + 8]
        data = buf[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    W, H, depth, ctype, _comp, _filt, interlace = header
    if depth != 8 or ctype != 0 or interlace != 0:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {ctype}, interlace {interlace}")
    try:
        data = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG image data ({e})") from e
    if len(data) != H * (W + 1):
        raise ValueError(f"PNG image data of {len(data)} bytes for {W}x{H} pixels")
    return _unfilter(data, H, W)


def write_gray(path, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_gray(img))


def read_gray(path) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_gray(f.read())
