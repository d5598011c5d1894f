"""The port's host image IO (wass_tpu_torch/io/image.py, io/png.py) against
the JAX package's: its native libpng reader and libjpeg encoder
(wass_tpu/native) and its imageio calls.

Tolerances: every comparison is exact (bit-equal arrays), JPEG included:
OpenCV and imageio (Pillow) decode the same JPEG to the same array here,
and OpenCV's encoder, Pillow's and the native one give the same decoded
images at the same quality.  The JPEG bytes are not compared: they
differ by encoder build."""

import io

import cv2
import imageio.v3 as iio
import numpy as np
import pytest
from PIL import Image

from wass_tpu import native
from wass_tpu.cli.main import _read_gray

from wass_tpu_torch.io import image, png
from wass_tpu_torch.io.prefetch import Prefetcher
from wass_tpu_torch.testing import png_with_filters


def _scene(rng, shape=(37, 53)):
    """A smooth image with noise and flat rows (where the PNG predictors
    differ most)."""
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    img = 127 + 100 * np.sin(xx / 7.0) * np.cos(yy / 5.0) + rng.normal(0, 12, shape)
    img[5:9] = 77
    return np.clip(img, 0, 255).astype(np.uint8)


def _row_filters(data: bytes, shape) -> list:
    """The filter type of each row of a PNG."""
    import struct
    import zlib

    idat, pos = [], 8
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(shape[0], shape[1] + 1)
    return rows[:, 0].tolist()


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, "mixed"])
def test_decode_matches_numpy_codec_every_filter(rng, ftype):
    img = _scene(rng)
    ftypes = rng.integers(0, 5, img.shape[0]) if ftype == "mixed" else [ftype] * img.shape[0]
    data = png_with_filters(img, ftypes)
    want = png.decode_gray_plain(data)
    np.testing.assert_array_equal(want, img)
    np.testing.assert_array_equal(png.decode_gray(data), want)
    np.testing.assert_array_equal(image.decode_gray(data), want)


@pytest.mark.parametrize("writer", ["native", "cv2_level1", "cv2_level9", "pil"])
def test_decode_matches_numpy_codec_libpng_writers(rng, tmp_path, writer):
    """PNGs of libpng's adaptive row filters: the JAX package's native
    writer, OpenCV's and Pillow's."""
    img = _scene(rng, (61, 97))
    path = tmp_path / "a.png"
    if writer == "native":
        native.png_write_gray(path, img)
    elif writer == "pil":
        Image.fromarray(img).save(path)
    else:
        cv2.imwrite(str(path), img, [cv2.IMWRITE_PNG_COMPRESSION, int(writer[-1])])
    data = path.read_bytes()
    assert len(set(_row_filters(data, img.shape))) > 1  # libpng chose several row filters
    want = png.decode_gray_plain(data)
    np.testing.assert_array_equal(want, img)
    np.testing.assert_array_equal(png.read_gray(path), want)
    np.testing.assert_array_equal(native.png_read_gray(path), want)


def _write(path, arr, how):
    if how == "cv2":
        assert cv2.imwrite(str(path), arr)
    elif how == "pil_palette":
        Image.fromarray(arr).convert("P", palette=Image.ADAPTIVE, colors=32).save(path)
    elif how == "pil_la":
        Image.fromarray(arr, "LA").save(path)
    else:
        iio.imwrite(path, arr, **({"quality": 90} if how == "iio_q90" else {}))


def _frames(rng):
    g = _scene(rng)
    rgb = np.stack([g, 255 - g, np.roll(g, 7, axis=1)], axis=-1)
    rgb[:4] = g[:4, :, None]  # grey pixels (R = G = B) come out as they are
    u16 = rng.integers(0, 65536, g.shape).astype(np.uint16)
    c16 = rng.integers(0, 65536, g.shape + (3,)).astype(np.uint16)
    return {
        "colour.png": (rgb[..., ::-1], "cv2"),
        "colour_alpha.png": (np.dstack([rgb[..., ::-1], g]), "cv2"),
        "palette.png": (rgb, "pil_palette"),
        "gray_alpha.png": (np.stack([g, 255 - g], axis=-1), "pil_la"),
        "gray16.png": (u16, "cv2"),
        "colour16.png": (c16, "cv2"),
        "gray.png": (g, "cv2"),
        "colour.jpg": (rgb, "iio_q90"),
        "gray.jpg": (g, "iio"),
        "uint8.tiff": (g, "iio"),
        "uint16.tiff": (u16, "iio"),
        "float32.tiff": ((rng.standard_normal(g.shape) * 300).astype(np.float32), "iio"),
        "colour.tiff": (rgb, "iio"),
        "colour_float32.tiff": (rng.standard_normal(g.shape + (3,)).astype(np.float32)[..., ::-1].copy(), "cv2"),
    }


@pytest.mark.parametrize("name", list(_frames(np.random.default_rng(0))))
def test_read_raw_frame_matches_jax(rng, tmp_path, name):
    """read_raw_frame against the JAX command's reader (native libpng for
    .png, imageio's channel mean otherwise): bit-equal, 16-bit TIFF values
    above 255 included (prepare clips them in both packages)."""
    arr, how = _frames(rng)[name]
    path = tmp_path / name
    _write(path, arr, how)
    want = _read_gray(path)
    got = image.read_raw_frame(path)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == arr.shape[:2]
    np.testing.assert_array_equal(got, want)
    if name == "uint16.tiff":
        assert got.max() > 255


def test_read_raw_frame_names_an_undecodable_file(tmp_path):
    (tmp_path / "a.png").write_bytes(b"GIF89a not an image")
    with pytest.raises(ValueError, match="a.png"):
        image.read_raw_frame(tmp_path / "a.png")


@pytest.mark.parametrize("shape", [(1, 1), (37, 53)])
def test_float_tiff_roundtrips_with_imageio(rng, tmp_path, shape):
    arr = (rng.standard_normal(shape) * 1e3).astype(np.float32)
    arr.flat[0] = np.nan
    image.write_float_tiff(tmp_path / "port.tiff", arr)
    back = iio.imread(tmp_path / "port.tiff")
    assert back.dtype == np.float32 and back.tobytes() == arr.tobytes()
    iio.imwrite(tmp_path / "iio.tiff", arr)
    back = image.read_float_tiff(tmp_path / "iio.tiff")
    assert back.dtype == np.float32 and back.tobytes() == arr.tobytes()
    iio.imwrite(tmp_path / "u8.tiff", np.zeros(shape, np.uint8))
    with pytest.raises(ValueError, match="float32"):
        image.read_float_tiff(tmp_path / "u8.tiff")


@pytest.mark.parametrize("colour", [False, True])
def test_render_jpeg_matches_imageio(rng, colour):
    """The renders' encoder: imageio's .jpg write is Pillow's default
    quality, 75; the port's JPEG at RENDER_QUALITY decodes to the same
    array, colours in RGB order."""
    g = _scene(rng, (64, 96))
    img = np.stack([g, 255 - g, np.roll(g, 5, axis=1)], axis=-1) if colour else g
    buf = io.BytesIO()
    iio.imwrite(buf, img, extension=".jpg")
    pil = io.BytesIO()
    Image.fromarray(img).save(pil, format="JPEG", quality=75)
    assert buf.getvalue() == pil.getvalue() and image.RENDER_QUALITY == 75
    got = iio.imread(io.BytesIO(image.encode_jpeg(img)))
    np.testing.assert_array_equal(got, iio.imread(io.BytesIO(buf.getvalue())))


def test_cube_jpeg_matches_native_encoder(rng):
    """cam0images: the port's quality-90 JPEG against the native encoder's,
    decoded (both through OpenCV and imageio) to the same array."""
    img = _scene(rng, (96, 128)).astype(np.float32)
    mine, theirs = image.encode_jpeg(img, image.CAM_IMAGE_QUALITY), native.jpeg_encode_gray(img)
    want = iio.imread(io.BytesIO(theirs))
    np.testing.assert_array_equal(image.decode_gray(mine), want)
    np.testing.assert_array_equal(image.decode_gray(theirs), want)
    assert np.abs(want.astype(int) - img).max() <= 20  # lossy, but near


def test_decode_gray_refuses_colour(rng):
    rgb = rng.integers(0, 256, (4, 5, 3), dtype=np.uint8)
    with pytest.raises(ValueError, match="grayscale"):
        image.decode_gray(cv2.imencode(".png", rgb)[1].tobytes())
    with pytest.raises(ValueError, match="cannot decode"):
        image.decode_gray(b"\xff\xd8 not a jpeg")


def test_codec_report_names_the_codecs():
    lines = image.codec_report()
    assert lines[0] == f"OpenCV {cv2.__version__}"
    for codec in image.CODECS:
        assert any(ln.startswith(f"{codec}:") for ln in lines), codec


def test_prefetcher_decodes_paeth_pngs(rng, tmp_path):
    """The prefetch threads decode any row filter through OpenCV."""
    imgs = [_scene(rng, (20 + i, 31)) for i in range(5)]
    for i, img in enumerate(imgs):
        (tmp_path / f"{i}.png").write_bytes(png_with_filters(img, [4] * img.shape[0]))
    with Prefetcher(4) as pf:
        tickets = [pf.submit(tmp_path / f"{i}.png") for i in range(5)]
        for i in (3, 0, 4, 1, 2):
            np.testing.assert_array_equal(pf.take(tickets[i]), imgs[i])
