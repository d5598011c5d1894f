"""Baseline JPEG encoding of uint8 images on the card, byte for byte as
OpenCV writes them (io/image.py:encode_jpeg, cv2.imencode over
libjpeg-turbo), and its plain NumPy version.

The stereo loop's writers encode their six debug renders here when the
images lie on a card (cli/pipeline.py:_write_renders): the kernel
(csrc/jpeg.cu) encodes all of a frame's images in one call of four
launches, and only the entropy-coded streams come back to the host, which
wraps each in its header and EOI.  The JAX package writes its renders
through imageio (wass_tpu/utils/render.py:21); the port's host path is
OpenCV, so OpenCV's bytes are the ones both versions reproduce.

What libjpeg-turbo does under OpenCV's settings (baseline, standard
Huffman tables, no restart markers, a JFIF 1.01 APP0 with density 1:1,
quality through the IJG scaling with baseline limits), in integers:

* grey (H, W): one component, 8x8 MCUs, samples level-shifted by -128;
* RGB (H, W, 3): libjpeg's RGB -> YCbCr (FIX(x) = round(x 2^16); Y adds
  1 << 15, Cb and Cr (128 << 16) + (1 << 15) - 1, then >> 16), 4:2:0:
  16x16 MCUs of Y0 Y1 Y2 Y3 Cb Cr, the chroma h2v2-downsampled as
  (a + b + c + d + bias) >> 2, the bias 1, 2, 1, 2 along each output row;
* edges: each component's samples replicated from the last column to its
  blocks' width (colour at full resolution to ceil(W / 16) 16 before the
  downsampling) and from the last row down (colour: the rows padded to an
  even count, downsampled, then the last chroma row repeated); an MCU's
  Y blocks past the component's blocks are dummy blocks, zeros with the
  DC of the block before them in the MCU;
* jfdctint's islow DCT (CONST_BITS 13, PASS1_BITS 2) and the quantisation
  by 8 q with libjpeg-turbo's reciprocals, which equal rounding |x| / 8 q
  half up and restoring the sign;
* Huffman coding with DC prediction per component across the scan, a
  0x00 after every 0xFF, and the last byte padded with 1-bits.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from wass_tpu_torch import _build
from wass_tpu_torch.device import on_cuda
from wass_tpu_torch.instrument import LaunchCounts

LAUNCHES = LaunchCounts({"jpeg": 0})

KERNELS_A_CALL = 4  # transform, bit offsets, emit, stuff
MAX_IMAGES = 8  # images a kernel call takes (csrc/jpeg.cu: kMaxImages)
MAX_BLOCK_BITS = 1660  # a block's longest code: DC 11 + 11 bits, 63 AC of 16 + 10
SCAN_TILE = 2048  # blocks a tile of the bit-offset scan (csrc/jpeg.cu: kScanThreads x kScanItems)
STUFF_TILE_WORDS = 1024  # stream words a tile of the byte stuffing (kStuffThreads x 4)
EOI = b"\xff\xd9"

# The natural (row-major) index of each zig-zag position.
ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,
                   6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45,
                   38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# The IJG base tables (JPEG Annex K), natural order.
LUMA_Q = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56,
                   14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
                   49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
CHROMA_Q = np.full(64, 99)
CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]

# The standard Huffman tables (Annex K.3): code counts by length 1-16, symbols.
DC_BITS = (bytes.fromhex("00010501010101010100000000000000"), bytes.fromhex("00030101010101010101010000000000"))
DC_VALS = (bytes(range(12)), bytes(range(12)))
AC_BITS = (bytes.fromhex("0002010303020403050504040000017d"), bytes.fromhex("00020102040403040705040400010277"))
AC_VALS = (
    bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a25262728292a3435"
        "363738393a434445464748494a535455565758595a636465666768696a737475767778797a838485868788898a9293949596979899"
        "9aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6"
        "f7f8f9fa"),
    bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f11718191a262728292a35"
        "363738393a434445464748494a535455565758595a636465666768696a737475767778797a82838485868788898a92939495969798"
        "999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7"
        "f8f9fa"),
)

# libjpeg's RGB -> YCbCr constants, FIX(x) = round(x 2^16).
FIX_Y = (19595, 38470, 7471)
FIX_CB = (-11059, -21709, 32768)
FIX_CR = (32768, -27439, -5329)
CBCR_OFFSET = (128 << 16) + (1 << 15) - 1


def quant_tables(quality: int) -> np.ndarray:
    """(2, 64) luma and chroma divisors, natural order, as jpeg_set_quality
    (quality, force_baseline=TRUE) makes them; quality is clamped to
    [1, 100] as libjpeg does (OpenCV clamps it to [0, 100] first)."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.stack([np.clip((base * scale + 50) // 100, 1, 255) for base in (LUMA_Q, CHROMA_Q)])


def reciprocals(divisors: np.ndarray) -> tuple:
    """libjpeg-turbo's quantisation by 8 q (jcdctmgr.c:compute_reciprocal
    with 16-bit DCTELEM): (reciprocal, correction, shift) arrays such that
    |x| / 8 q rounded half up is ((|x| + correction) * reciprocal) >> shift."""
    d = 8 * np.asarray(divisors, np.int64)
    b = np.floor(np.log2(d)).astype(np.int64)
    r = 16 + b
    fq, fr = np.divmod(np.int64(1) << r, d)
    c = d // 2
    pow2 = fr == 0
    fq = np.where(pow2, fq >> 1, np.where(fr > d // 2, fq + 1, fq))
    c = np.where(~pow2 & (fr <= d // 2), c + 1, c)
    r = np.where(pow2, r - 1, r)
    return fq, c, r


def huffman_codes(bits: bytes, vals: bytes) -> tuple:
    """(code, length) arrays by symbol (256 entries; length 0 where the
    table has no code), the canonical codes of Annex C."""
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    c = 0
    k = 0
    for n, count in enumerate(bits, start=1):
        for _ in range(count):
            code[vals[k]] = c
            length[vals[k]] = n
            c += 1
            k += 1
        c <<= 1
    return code, length


def _shape(img_shape) -> tuple:
    """(H, W, components) of an (H, W) grey or (H, W, 3) RGB image."""
    if len(img_shape) == 2:
        return int(img_shape[0]), int(img_shape[1]), 1
    if len(img_shape) == 3 and img_shape[2] == 3:
        return int(img_shape[0]), int(img_shape[1]), 3
    raise ValueError(f"jpeg: an (H, W) grey or (H, W, 3) RGB image expected, got shape {tuple(img_shape)}")


def _check_size(H: int, W: int) -> None:
    if not (1 <= H <= 65535 and 1 <= W <= 65535):
        raise ValueError(f"jpeg: each side must be 1-65535 pixels, got {H}x{W}")


def header(height: int, width: int, components: int, quality: int) -> bytes:
    """SOI, JFIF APP0, DQT, SOF0, DHT and SOS as libjpeg-turbo writes them
    under OpenCV's settings (jcmarker.c)."""
    tables = quant_tables(quality)[: 1 if components == 1 else 2]
    out = bytearray(b"\xff\xd8\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for i, t in enumerate(tables):
        out += b"\xff\xdb\x00\x43" + bytes([i]) + bytes(t[ZIGZAG].astype(np.uint8))
    comps = [(1, 0x11, 0)] if components == 1 else [(1, 0x22, 0), (2, 0x11, 1), (3, 0x11, 1)]
    out += b"\xff\xc0" + struct.pack(">HBHHB", 8 + 3 * len(comps), 8, height, width, len(comps))
    out += b"".join(bytes(c) for c in comps)
    for i in range(len(tables)):
        for cls, bits, vals in ((0, DC_BITS[i], DC_VALS[i]), (1, AC_BITS[i], AC_VALS[i])):
            out += b"\xff\xc4" + struct.pack(">H", 3 + 16 + len(vals)) + bytes([cls << 4 | i]) + bits + vals
    out += b"\xff\xda" + struct.pack(">HB", 6 + 2 * len(comps), len(comps))
    out += b"".join(bytes([cid, t << 4 | t]) for cid, _, t in comps) + b"\x00\x3f\x00"
    return bytes(out)


# ---------------------------------------------------------------- plain version


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _fdct_pass(d: np.ndarray, axis: int, first: bool) -> np.ndarray:
    """One pass of jpeg_fdct_islow along `axis` (rows first, then columns)."""
    x = [np.take(d, k, axis=axis) for k in range(8)]
    tmp0, tmp7 = x[0] + x[7], x[0] - x[7]
    tmp1, tmp6 = x[1] + x[6], x[1] - x[6]
    tmp2, tmp5 = x[2] + x[5], x[2] - x[5]
    tmp3, tmp4 = x[3] + x[4], x[3] - x[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    o = [None] * 8
    if first:
        o[0], o[4], n = (tmp10 + tmp11) << 2, (tmp10 - tmp11) << 2, 11
    else:
        o[0], o[4], n = _descale(tmp10 + tmp11, 2), _descale(tmp10 - tmp11, 2), 15
    z1 = (tmp12 + tmp13) * 4433
    o[2] = _descale(z1 + tmp13 * 6270, n)
    o[6] = _descale(z1 - tmp12 * 15137, n)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * 9633
    tmp4, tmp5, tmp6, tmp7 = tmp4 * 2446, tmp5 * 16819, tmp6 * 25172, tmp7 * 12299
    z1, z2, z3, z4 = z1 * -7373, z2 * -20995, z3 * -16069 + z5, z4 * -3196 + z5
    o[7] = _descale(tmp4 + z1 + z3, n)
    o[5] = _descale(tmp5 + z2 + z4, n)
    o[3] = _descale(tmp6 + z2 + z3, n)
    o[1] = _descale(tmp7 + z1 + z4, n)
    return np.stack(o, axis=axis)


def _quantized_blocks(plane: np.ndarray, nby: int, nbx: int, divisors: np.ndarray) -> np.ndarray:
    """(nby, nbx, 64) quantised coefficients, zig-zag order, of the plane's
    top-left nby x nbx blocks (the plane already edge-extended)."""
    blocks = plane[: 8 * nby, : 8 * nbx].reshape(nby, 8, nbx, 8).transpose(0, 2, 1, 3).astype(np.int64) - 128
    coef = _fdct_pass(_fdct_pass(blocks, -1, True), -2, False).reshape(nby, nbx, 64)
    fq, c, r = reciprocals(divisors)
    q = ((np.abs(coef) + c) * fq) >> r
    return np.where(coef < 0, -q, q)[..., ZIGZAG]


def _edge(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    return np.pad(plane, ((0, rows - plane.shape[0]), (0, cols - plane.shape[1])), mode="edge")


def _ycbcr(img: np.ndarray) -> tuple:
    r, g, b = (img[..., k].astype(np.int64) for k in range(3))
    y = (FIX_Y[0] * r + FIX_Y[1] * g + FIX_Y[2] * b + (1 << 15)) >> 16
    cb = (FIX_CB[0] * r + FIX_CB[1] * g + FIX_CB[2] * b + CBCR_OFFSET) >> 16
    cr = (FIX_CR[0] * r + FIX_CR[1] * g + FIX_CR[2] * b + CBCR_OFFSET) >> 16
    return y, cb, cr


def _downsample(plane: np.ndarray, H: int, mcu_rows: int, mcu_cols: int) -> np.ndarray:
    """h2v2_downsample of a full-resolution chroma plane: the columns
    replicated to 16 mcu_cols, the rows to an even count, then the last
    output row repeated down to 8 mcu_rows."""
    p = _edge(plane, H + (H & 1), 16 * mcu_cols)
    bias = np.where(np.arange(8 * mcu_cols) % 2 == 0, 1, 2)
    ds = (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2] + bias) >> 2
    return _edge(ds, 8 * mcu_rows, 8 * mcu_cols)


def scan_blocks(img: np.ndarray, quality: int) -> tuple:
    """The quantised blocks in scan order: ((n, 64) zig-zag coefficients,
    (n,) Huffman table index (0 luma, 1 chroma), (n,) index of the block
    that predicts each block's DC, -1 for the first of its component)."""
    H, W, ncomp = _shape(img.shape)
    q = quant_tables(quality)
    if ncomp == 1:
        nby, nbx = -(-H // 8), -(-W // 8)
        coefs = _quantized_blocks(_edge(img.astype(np.int64), 8 * nby, 8 * nbx), nby, nbx, q[0]).reshape(-1, 64)
        n = len(coefs)
        return coefs, np.zeros(n, np.int64), np.arange(n) - 1
    mr, mc = -(-H // 16), -(-W // 16)
    nby, nbx = -(-H // 8), -(-W // 8)
    y, cb, cr = _ycbcr(img)
    ext = np.zeros((2 * mr, 2 * mc, 64), np.int64)
    ext[:nby, :nbx] = _quantized_blocks(_edge(y, 8 * nby, 8 * nbx), nby, nbx, q[0])
    # Dummy blocks (jccoefct.c:compress_data): zeros, the DC of the block
    # before them in the MCU (Y1 <- Y0, Y2 <- Y1, Y3 <- Y2).
    right = (2 * np.arange(mc) + 1 >= nbx)[None, :]
    bottom = (2 * np.arange(mr) + 1 >= nby)[:, None]
    dc = ext[..., 0]
    dc[0::2, 1::2] = np.where(right, dc[0::2, 0::2], dc[0::2, 1::2])
    dc[1::2, 0::2] = np.where(bottom, dc[0::2, 1::2], dc[1::2, 0::2])
    dc[1::2, 1::2] = np.where(right | bottom, dc[1::2, 0::2], dc[1::2, 1::2])
    luma = ext.reshape(mr, 2, mc, 2, 64).transpose(0, 2, 1, 3, 4).reshape(mr * mc, 4, 64)
    chroma = [_quantized_blocks(_downsample(p, H, mr, mc), mr, mc, q[1]).reshape(mr * mc, 1, 64) for p in (cb, cr)]
    coefs = np.concatenate([luma, *chroma], axis=1).reshape(-1, 64)
    n = len(coefs)
    g = np.arange(n)
    pos = g % 6
    prev = np.where(pos == 0, g - 3, np.where(pos < 4, g - 1, g - 6))
    prev = np.where((pos != 1) & (pos != 2) & (pos != 3) & (g < 6), -1, prev)
    return coefs, (pos >= 4).astype(np.int64), prev


def _nbits(a: np.ndarray) -> np.ndarray:
    """Bits of |a| (a >= 0), 0 for 0."""
    out = np.zeros(a.shape, np.int64)
    nz = a > 0
    out[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return out


def _value_bits(v: np.ndarray, nb: np.ndarray) -> np.ndarray:
    return np.where(v < 0, v - 1, v) & ((np.int64(1) << nb) - 1)


def entropy_code(coefs: np.ndarray, table: np.ndarray, prev: np.ndarray) -> bytes:
    """The entropy-coded segment of the blocks (scan_blocks' arrays): the
    Huffman tokens of every block in order, packed MSB first, the last
    byte padded with 1-bits, a 0x00 after every 0xFF."""
    dc_tabs = [huffman_codes(DC_BITS[i], DC_VALS[i]) for i in range(2)]
    ac_tabs = [huffman_codes(AC_BITS[i], AC_VALS[i]) for i in range(2)]
    dcode, dlen = (np.stack([t[k] for t in dc_tabs]) for k in range(2))
    acode, alen = (np.stack([t[k] for t in ac_tabs]) for k in range(2))
    n = len(coefs)
    dc = coefs[:, 0]
    diff = dc - np.where(prev >= 0, dc[np.maximum(prev, 0)], 0)
    nb = _nbits(np.abs(diff))
    tok = [(dcode[table, nb] << nb) | _value_bits(diff, nb)]
    length = [dlen[table, nb] + nb]
    key = [np.arange(n) * 65]
    bi, j = np.nonzero(coefs[:, 1:])
    pos = j + 1
    first = np.ones(len(bi), bool)
    first[1:] = bi[1:] != bi[:-1]
    run = pos - np.where(first, 0, np.roll(pos, 1)) - 1
    v = coefs[bi, pos]
    nb = _nbits(np.abs(v))
    t = table[bi]
    sym = (run & 15) << 4 | nb
    z = run >> 4
    zc, zl = acode[t, 0xF0], alen[t, 0xF0]
    zrl = np.zeros(len(bi), np.int64)
    for k in range(1, 4):  # a run of up to 62 zeros: at most 3 ZRL codes
        zrl = np.where(z >= k, (zrl << zl) | zc, zrl)
    clen = alen[t, sym]
    tok.append((((zrl << clen) | acode[t, sym]) << nb) | _value_bits(v, nb))
    length.append(z * zl + clen + nb)
    key.append(bi * 65 + pos)
    last = np.zeros(n, np.int64)
    ends = np.ones(len(bi), bool)
    ends[:-1] = bi[:-1] != bi[1:]
    last[bi[ends]] = pos[ends]
    eob = np.nonzero(last < 63)[0]
    tok.append(acode[table[eob], 0])
    length.append(alen[table[eob], 0])
    key.append(eob * 65 + 64)
    order = np.argsort(np.concatenate(key))
    tok = np.concatenate(tok)[order].astype(np.uint64)
    length = np.concatenate(length)[order]
    start = np.concatenate([[0], np.cumsum(length)[:-1]])
    total = int(length.sum())
    nbytes = (total + 7) // 8
    # Each token (<= 60 bits) covers at most 9 bytes; OR its bits into them
    # (the tokens' bits are disjoint, so a sum does).
    left = tok << (64 - length).astype(np.uint64)
    b0, o = start >> 3, (start & 7).astype(np.uint64)
    acc = np.zeros(nbytes + 9, np.float64)
    for k in range(9):
        part = (left >> (np.uint64(56 - 8 * k) + o)) if k < 8 else (left << (np.uint64(8) - o))
        inside = 8 * k - (start & 7) < length
        acc += np.bincount(b0[inside] + k, weights=(part[inside] & np.uint64(0xFF)).astype(np.float64),
                           minlength=len(acc))
    stream = acc[:nbytes].astype(np.uint8)
    if total % 8:
        stream[-1] |= 0xFF >> (total % 8)
    return np.insert(stream, np.nonzero(stream == 0xFF)[0] + 1, 0).tobytes()


def encode_plain(img: np.ndarray, quality: int) -> bytes:
    """JPEG bytes of an (H, W) grey or (H, W, 3) RGB uint8 image, equal to
    io/image.py:encode_jpeg's (OpenCV's) for the same image and quality."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"jpeg: uint8 images expected, got {img.dtype}")
    H, W, ncomp = _shape(img.shape)
    _check_size(H, W)
    return header(H, W, ncomp, quality) + entropy_code(*scan_blocks(img, quality)) + EOI


# ---------------------------------------------------------------- the kernel


def layout(shapes) -> tuple:
    """The buffers of a kernel call on images of these (H, W, components)
    shapes: per image (blocks, stream words, first stream word, first
    output byte), and the totals (blocks, stream words, output bytes,
    uint64 scan states).  An image's words hold its worst-case stream
    (MAX_BLOCK_BITS a block, a multiple of 4 words) and its output twice
    those bytes (a 0x00 after every byte)."""
    rows = []
    slots = words = out = 0
    states = 2  # the two tile counters
    for H, W, C in shapes:
        mcu = 8 if C == 1 else 16
        n = -(-W // mcu) * -(-H // mcu) * (1 if C == 1 else 6)
        nw = 4 * -(-(n * MAX_BLOCK_BITS + 7) // 128)
        if 32 * nw > 0xFFFFFFFF:
            raise ValueError(f"jpeg: a {H}x{W} image is too large for the kernel's 32-bit bit offsets")
        rows.append((n, nw, words, out))
        slots += n
        words += nw
        out += 8 * nw
        states += -(-n // SCAN_TILE) + -(-nw // STUFF_TILE_WORDS)
    return rows, slots, words, out, states


def table_words(quality: int, nimg: int) -> np.ndarray:
    """The kernel's uint32 tables: for each image its luma and chroma
    quantisation entries (natural order; reciprocal | correction << 16 |
    shift << 27), then the Huffman entries (length << 16 | code) of DC
    luma, DC chroma (16 each), AC luma and AC chroma (256 each)."""
    fq, c, r = reciprocals(quant_tables(quality).reshape(-1))
    quant = (fq | c << 16 | r << 27).astype(np.uint32)
    huff = []
    for bits, vals, n in ((DC_BITS, DC_VALS, 16), (AC_BITS, AC_VALS, 256)):
        for i in range(2):
            code, length = huffman_codes(bits[i], vals[i])
            huff.append((length[:n] << 16 | code[:n]).astype(np.uint32))
    return np.concatenate([np.tile(quant, nimg), *huff])


class DeviceEncoder:
    """The card's buffers for one list of image shapes and one quality,
    reused from call to call: launch() enqueues the kernels on the current
    stream, run() also waits for the streams' byte counts, fetch() copies
    the streams and wraps each in its header and EOI."""

    def __init__(self, shapes, quality: int, device):
        self.shapes = tuple(shapes)
        if not 1 <= len(self.shapes) <= MAX_IMAGES:
            raise ValueError(f"jpeg: 1-{MAX_IMAGES} images a call, got {len(self.shapes)}")
        for H, W, _ in self.shapes:
            _check_size(H, W)
        rows, slots, words, out, states = layout(self.shapes)
        self.device = torch.device(device)
        self.headers = [header(H, W, C, quality) for H, W, C in self.shapes]
        # 8 int64 an image (csrc/jpeg.cu:wass_jpeg_encode); launch() sets the pixel pointers.
        self.plan = np.array([(0, H, W, C, 128 * i, wb, nw, ob)
                              for i, ((H, W, C), (_, nw, wb, ob)) in enumerate(zip(self.shapes, rows))], np.int64)
        self.out_base = [ob for _, _, _, ob in rows]
        self.tables = torch.from_numpy(table_words(quality, len(self.shapes)).view(np.int32)).to(self.device)
        i32 = dict(dtype=torch.int32, device=self.device)
        self.coefs = torch.empty(64 * slots, dtype=torch.int16, device=self.device)
        self.dc, self.aclen, self.off = (torch.empty(slots, **i32) for _ in range(3))
        self.words = torch.empty(words, **i32)
        self.out = torch.empty(out, dtype=torch.uint8, device=self.device)
        self.nbits, self.counts = (torch.empty(len(self.shapes), **i32) for _ in range(2))
        self.states = torch.empty(states, dtype=torch.int64, device=self.device)
        self.counts_host = torch.empty(len(self.shapes), dtype=torch.int32, pin_memory=True)
        self.host = torch.empty(0, dtype=torch.uint8, pin_memory=True)
        self.done = torch.cuda.Event()

    def launch(self, images) -> None:
        """Enqueue the kernels on `images` (uint8 tensors of the encoder's
        shapes on its card) on the current stream."""
        if len(images) != len(self.shapes):
            raise ValueError(f"jpeg: {len(self.shapes)} images expected, got {len(images)}")
        for t, shape in zip(images, self.shapes):
            if t.dtype != torch.uint8 or not t.is_contiguous() or t.device != self.device or _shape(t.shape) != shape:
                raise ValueError(f"jpeg: contiguous uint8 images of shapes {self.shapes} on {self.device} expected, "
                                 f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        self.plan[:, 0] = [t.data_ptr() for t in images]
        _build.launch("wass_jpeg_encode", "jpeg kernels", self.device, self.plan.ctypes.data, len(images),
                      self.tables.data_ptr(), 128 * len(images), self.coefs.data_ptr(), self.dc.data_ptr(),
                      self.aclen.data_ptr(), self.off.data_ptr(), self.words.data_ptr(), self.out.data_ptr(),
                      self.nbits.data_ptr(), self.counts.data_ptr(), self.states.data_ptr(), self.states.numel())
        for _ in range(KERNELS_A_CALL):
            LAUNCHES.add("jpeg")

    def run(self, images) -> list:
        """launch(), then one wait for the streams' byte counts, which it
        returns."""
        self.launch(images)
        self.counts_host.copy_(self.counts, non_blocking=True)
        self.done.record(torch.cuda.current_stream(self.device))
        self.done.synchronize()
        return self.counts_host.tolist()

    def fetch(self, sizes) -> list:
        """The JPEG files of the last run() from its byte counts: one copy a
        stream into a pinned buffer, one wait."""
        total = sum(sizes)
        if self.host.numel() < total:
            self.host = torch.empty(2 * total, dtype=torch.uint8, pin_memory=True)
        a = 0
        for base, n in zip(self.out_base, sizes):
            self.host[a:a + n].copy_(self.out[base:base + n], non_blocking=True)
            a += n
        self.done.record(torch.cuda.current_stream(self.device))
        self.done.synchronize()
        host = self.host.numpy()
        files, a = [], 0
        for hdr, n in zip(self.headers, sizes):
            files.append(hdr + host[a:a + n].tobytes() + EOI)
            a += n
        return files


def device_encoder(cache: dict, images, quality: int) -> DeviceEncoder:
    """The encoder in `cache` (its owner's: a writer thread keeps one) for
    these images' card, shapes and quality, its buffers allocated at the
    first call."""
    key = (images[0].device, tuple(_shape(t.shape) for t in images), int(quality))
    enc = cache.get(key)
    if enc is None:
        enc = cache[key] = DeviceEncoder(key[1], key[2], key[0])
    return enc


def encode(images, quality: int) -> list:
    """JPEG files of uint8 (H, W) grey or (H, W, 3) RGB tensors, equal to
    OpenCV's: on the card through the kernel (up to MAX_IMAGES, one call,
    buffers of its own), on the CPU through the plain version."""
    images = list(images)
    if not images:
        return []
    if not on_cuda(*images):
        return [encode_plain(t.numpy(), quality) for t in images]
    enc = device_encoder({}, images, quality)
    return enc.fetch(enc.run(images))
