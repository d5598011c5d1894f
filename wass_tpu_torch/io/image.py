"""Host image IO through OpenCV: raw frames of any format, gray PNG and
JPEG decode, float32 TIFFs and JPEG encode.

Counterpart of the JAX package's native library (wass_tpu/native:
png_read_gray on libpng, jpeg_encode_gray on libjpeg) and of its imageio
calls (the raw frames of `prepare`, the Stokes TIFFs, the JPEG frames of
the grid cube, the debug renders).  Neither libpng's headers nor imageio
are on the card's host; OpenCV is, with its PNG, JPEG and TIFF codecs
(codec_report).  cv2.imdecode and cv2.imencode release the interpreter
lock, so decodes on several threads run at once.

Raw frames follow the JAX command (wass_tpu/cli/main.py:_read_gray), whose
path is fixed by the file's extension:
  - `.png` as the native reader sets libpng up: palette expanded, 16 bits
    cut to the high byte, alpha dropped, colour turned to grey with
    libpng's fixed-point weights (png_set_rgb_to_gray_fixed(png, 1, -1, -1)
    on a file without gAMA, cHRM or sRGB chunks);
  - every other format as imageio reads it: the mean over the channels
    (R, G, B and alpha, in that order) in the array's dtype, as float32.
"""

from __future__ import annotations

from pathlib import Path

import cv2
import numpy as np

# libpng's default rgb_to_gray coefficients (ITU-R BT.709, scaled by 2^15).
_RGB_TO_GRAY = (6968, 23434, 2366)
# imageio's channel order (RGB, RGBA) out of OpenCV's (BGR, BGRA).
_RGB_ORDER = {3: [2, 1, 0], 4: [2, 1, 0, 3]}
CAM_IMAGE_QUALITY = 90  # the grid cube's cam0images (the native encoder's default)
RENDER_QUALITY = 75  # the debug renders: Pillow's default, which imageio's .jpg write takes
CODECS = ("PNG", "JPEG", "TIFF")


def _decode(buf: bytes, what) -> np.ndarray:
    img = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_UNCHANGED)
    if img is None:
        raise ValueError(f"cannot decode {what}: not an image OpenCV {cv2.__version__} reads")
    return img


def _encode(ext: str, img: np.ndarray, params=()) -> bytes:
    ok, buf = cv2.imencode(ext, img, list(params))
    if not ok:
        raise ValueError(f"OpenCV {cv2.__version__} cannot encode {ext} ({img.dtype} {img.shape})")
    return buf.tobytes()


def _png_gray(img: np.ndarray) -> np.ndarray:
    """libpng's 8-bit grey reading of a decoded PNG (OpenCV's BGR order)."""
    sixteen = img.dtype == np.uint16
    if img.ndim == 3:
        b, g, r = (img[..., k].astype(np.uint32) for k in range(3))  # alpha, if any, dropped
        gray = _RGB_TO_GRAY[0] * r + _RGB_TO_GRAY[1] * g + _RGB_TO_GRAY[2] * b
        if sixteen:
            gray += 16384  # libpng rounds its 16-bit grey and truncates its 8-bit one
        img = np.where((r == g) & (g == b), r, gray >> 15)
    if sixteen:
        img = img >> 8
    return img.astype(np.uint8)


def read_image(path) -> np.ndarray:
    """An image file as imageio reads it: (H, W), or (H, W, C) in R, G, B
    (and alpha) order, in the file's dtype; ValueError names a file that
    does not decode."""
    img = _decode(Path(path).read_bytes(), path)
    return img[..., _RGB_ORDER[img.shape[2]]] if img.ndim == 3 else img


def read_raw_frame(path) -> np.ndarray:
    """A raw camera frame as an (H, W) float32 image, as the JAX command
    reads it (module docstring)."""
    path = Path(path)
    if path.suffix.lower() == ".png":
        return _png_gray(_decode(path.read_bytes(), path)).astype(np.float32)
    img = read_image(path)
    if img.ndim == 3:
        img = img.mean(axis=-1)
    return img.astype(np.float32)


def decode_gray(buf: bytes) -> np.ndarray:
    """(H, W) uint8 image from grayscale PNG (any row filter) or JPEG bytes."""
    img = _decode(buf, "the image bytes")
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"expected an 8-bit grayscale image, got {img.dtype} {img.shape}")
    return img


def encode_jpeg(img: np.ndarray, quality: int = RENDER_QUALITY) -> bytes:
    """JPEG bytes of an (H, W) grey or (H, W, 3) RGB image, clipped to
    [0, 255] and cast to uint8 as the JAX package's writers do."""
    img = np.clip(img, 0, 255).astype(np.uint8)
    if img.ndim == 3:
        img = np.ascontiguousarray(img[..., ::-1])  # RGB -> OpenCV's BGR
    return _encode(".jpg", img, (cv2.IMWRITE_JPEG_QUALITY, int(quality)))


def write_float_tiff(path, arr: np.ndarray) -> None:
    """An (H, W) float32 TIFF (the Stokes images of prepare's save_stokes)."""
    Path(path).write_bytes(_encode(".tiff", np.ascontiguousarray(arr, np.float32)))


def read_float_tiff(path) -> np.ndarray:
    img = _decode(Path(path).read_bytes(), path)
    if img.ndim != 2 or img.dtype != np.float32:
        raise ValueError(f"{path}: expected an (H, W) float32 TIFF, got {img.dtype} {img.shape}")
    return img


def codec_report() -> list:
    """OpenCV's version and the codec lines of its build; raises when the
    PNG, JPEG or TIFF codec is missing."""
    info = cv2.getBuildInformation()
    media = info.split("Media I/O:", 1)[-1].split("Video I/O:", 1)[0]
    lines = [ln.strip() for ln in media.splitlines() if ln.strip()]
    missing = [c for c in CODECS
               if not any(ln.startswith(f"{c}:") and not ln.endswith("NO") for ln in lines)]
    if missing:
        raise RuntimeError(f"OpenCV {cv2.__version__} has no {', '.join(missing)} codec")
    return [f"OpenCV {cv2.__version__}"] + lines
