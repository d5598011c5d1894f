"""The JPEG encoder's plain version (wass_tpu_torch/io/jpeg.py) against
OpenCV's encoder (io/image.py:encode_jpeg, libjpeg-turbo), whole files
byte for byte, on the CPU: grey and RGB, qualities 75 and 90, every edge
case of the block grid, content that saturates each stage; the six renders
of a 256x192 frame through the wrapper's CPU dispatch; the header's
fields; the quantisation's reciprocals; and the kernel's buffer layout.
The kernel itself is held to the same files on the card
(tests/test_torch_kernels_cuda.py)."""

import struct

import numpy as np
import pytest
import torch

from wass_tpu_torch.io import jpeg
from wass_tpu_torch.io.image import RENDER_QUALITY, encode_jpeg
from wass_tpu_torch.stereo import dense
from wass_tpu_torch.utils import render

from torch_jpeg_cases import CASES, case_id, case_image

W, H = 256, 192


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_plain_encoder_equals_opencv(case):
    img, quality = case_image(case)
    assert jpeg.encode_plain(img, quality) == encode_jpeg(img, quality)


def _frame_renders(seed: int) -> dict:
    """The six renders of a 256x192 frame from seeded inputs with every
    failure code, NaN and out-of-range disparities and rectified values
    (tests/test_torch_render_reference.py's inputs), as CPU tensors."""
    rng = np.random.default_rng(seed)
    codes_all = (dense.FAIL_NO_DISPARITY, dense.FAIL_OUTSIDE_IMAGE, dense.FAIL_OUTSIDE_BBOX, dense.FAIL_BURNED,
                 dense.FAIL_ANGLE, dense.FAIL_TOO_CLOSE, dense.FAIL_TOO_DISTANT)
    disp = rng.uniform(-5.0, 170.0, (H, W)).astype(np.float32)
    disp[rng.random((H, W)) < 0.1] = np.nan
    codes = rng.choice(np.array((0, *codes_all), np.uint8), (H, W))
    valid = (codes == 0) & np.isfinite(disp)
    imgs = tuple(torch.from_numpy(rng.integers(0, 256, (H, W), dtype=np.uint8)) for _ in range(2))
    rect = tuple(torch.from_numpy(rng.uniform(-20.0, 280.0, (H, W)).astype(np.float32)) for _ in range(2))
    return render.stereo_renders(torch.from_numpy(disp), torch.from_numpy(valid), torch.from_numpy(codes), imgs, rect,
                                 (3, 5, W - 9, H - 20))


def test_frame_renders_through_the_wrapper_equal_opencv():
    images = _frame_renders(21)
    assert len(images) == 6 and {img.ndim for img in images.values()} == {2, 3}
    files = jpeg.encode(list(images.values()), RENDER_QUALITY)
    for (name, img), data in zip(images.items(), files):
        assert data == encode_jpeg(img.numpy()), name


def _segments(data: bytes) -> dict:
    """Marker -> list of segment payloads, up to SOS."""
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
    out, i = {}, 2
    while True:
        marker = data[i + 1]
        n = struct.unpack(">H", data[i + 2:i + 4])[0]
        out.setdefault(marker, []).append(data[i + 4:i + 2 + n])
        i += 2 + n
        if marker == 0xDA:
            return out


@pytest.mark.parametrize("components", [1, 3])
def test_header_fields(components):
    h, w = 37, 61
    seg = _segments(jpeg.header(h, w, components, 75) + jpeg.EOI)
    assert seg[0xE0] == [b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"]
    sof = seg[0xC0][0]
    assert struct.unpack(">BHHB", sof[:6]) == (8, h, w, components)
    comps = [tuple(sof[6 + 3 * k:9 + 3 * k]) for k in range(components)]
    assert comps == ([(1, 0x11, 0)] if components == 1 else [(1, 0x22, 0), (2, 0x11, 1), (3, 0x11, 1)])
    # The quality-75 tables: the IJG base tables halved, in zig-zag order.
    dqt = seg[0xDB]
    assert len(dqt) == (1 if components == 1 else 2)
    assert dqt[0][:9] == bytes([0, 8, 6, 6, 7, 6, 5, 8, 7])
    assert dqt[0][1:] == bytes(((jpeg.LUMA_Q[jpeg.ZIGZAG] * 50 + 50) // 100).astype(np.uint8))
    if components == 3:
        assert dqt[1][:1] == b"\x01" and dqt[1][1:5] == bytes([9, 9, 9, 12]) and set(dqt[1][20:]) == {50}
    assert [s[0] for s in seg[0xC4]] == ([0x00, 0x10] if components == 1 else [0x00, 0x10, 0x01, 0x11])
    assert seg[0xDA][0] == (b"\x01\x01\x00\x00\x3f\x00" if components == 1
                            else b"\x03\x01\x00\x02\x11\x03\x11\x00\x3f\x00")
    # OpenCV writes the same header.
    img = np.zeros((h, w) if components == 1 else (h, w, 3), np.uint8)
    ref = encode_jpeg(img, 75)
    hdr = jpeg.header(h, w, components, 75)
    assert ref[:len(hdr)] == hdr


def test_reciprocals_equal_rounded_division():
    """libjpeg-turbo's reciprocal quantisation rounds |x| / 8 q half up for
    every divisor of a baseline table and every |x| of the DCT's range."""
    x = np.arange(0, 16385, dtype=np.int64)
    q = np.arange(1, 256)
    fq, c, r = jpeg.reciprocals(q)
    for qi, f, ci, ri in zip(q, fq, c, r):
        assert np.array_equal(((x + ci) * f) >> ri, (x + 4 * qi) // (8 * qi)), qi
    assert fq.max() < 1 << 16 and c.max() < 1 << 11 and r.max() < 32


@pytest.mark.parametrize("quality", [1, 10, 50, 75, 90, 100])
def test_quant_tables_follow_opencv_quality(quality):
    img = np.zeros((8, 8, 3), np.uint8)
    dqt = _segments(encode_jpeg(img, quality))[0xDB]
    tables = jpeg.quant_tables(quality)
    for k in range(2):
        assert dqt[k][1:] == bytes(tables[k][jpeg.ZIGZAG].astype(np.uint8))


def test_kernel_layout_covers_the_worst_case():
    """Each image's stream words hold MAX_BLOCK_BITS a block, aligned to 4
    words, its output twice its stream's bytes, and the states one a scan
    tile and a stuffing tile, after the two counters."""
    shapes = [(1920, 2560, 1), (1920, 5120, 3), (17, 23, 3), (1, 1, 1)]
    rows, slots, words, out, states = jpeg.layout(shapes)
    assert [r[0] for r in rows] == [240 * 320, 120 * 320 * 6, 2 * 2 * 6, 1]
    for n, nw, wb, ob in rows:
        assert nw % 4 == 0 and wb % 4 == 0 and 32 * nw >= n * jpeg.MAX_BLOCK_BITS + 7 and 32 * (nw - 4) < n * 1660 + 7
    assert [r[2] for r in rows] == list(np.cumsum([0] + [r[1] for r in rows[:-1]]))
    assert [r[3] for r in rows] == list(np.cumsum([0] + [8 * r[1] for r in rows[:-1]]))
    assert (slots, words, out) == (sum(r[0] for r in rows), sum(r[1] for r in rows), 8 * words)
    assert states == 2 + sum(-(-r[0] // jpeg.SCAN_TILE) + -(-r[1] // jpeg.STUFF_TILE_WORDS) for r in rows)
    with pytest.raises(ValueError, match="too large"):
        jpeg.layout([(16 * 2048, 16 * 1024, 3)])


def test_table_words():
    t = jpeg.table_words(75, 2)
    assert t.dtype == np.uint32 and len(t) == 2 * 128 + 2 * 16 + 2 * 256
    assert np.array_equal(t[:128], t[128:256])
    fq, c, r = jpeg.reciprocals(jpeg.quant_tables(75).reshape(-1))
    assert np.array_equal(t[:128] & 0xFFFF, fq) and np.array_equal(t[:128] >> 27, r)
    assert np.array_equal((t[:128] >> 16) & 0x7FF, c)
    code, length = jpeg.huffman_codes(jpeg.AC_BITS[0], jpeg.AC_VALS[0])
    ac = t[256 + 32:256 + 32 + 256]
    assert ac[0] == (4 << 16 | 0b1010) and ac[0xF0] == (11 << 16 | 0b11111111001)  # EOB, ZRL
    assert np.array_equal(ac >> 16, length) and np.array_equal(ac & 0xFFFF, code)


def test_cpu_tensors_take_the_plain_version_and_bad_input_raises():
    img = torch.from_numpy(case_image(CASES[0])[0])
    launches = jpeg.LAUNCHES["jpeg"]
    assert jpeg.encode([img], 75) == [encode_jpeg(img.numpy(), 75)]
    assert jpeg.LAUNCHES["jpeg"] == launches and jpeg.encode([], 75) == []
    with pytest.raises(ValueError, match="uint8"):
        jpeg.encode_plain(np.zeros((4, 4), np.float32), 75)
    with pytest.raises(ValueError, match="RGB"):
        jpeg.encode_plain(np.zeros((4, 4, 4), np.uint8), 75)
    with pytest.raises(ValueError, match="1-65535"):
        jpeg.encode_plain(np.zeros((0, 4), np.uint8), 75)
