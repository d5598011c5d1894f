"""Seeded test images for the JPEG encoder (wass_tpu_torch/io/jpeg.py):
the kinds of content that drive each stage of the encoder to its limits,
at sizes that take every edge case of the block grid (one pixel, one
block, a block and a pixel, ragged MCUs whose Y blocks are dummy blocks,
whole MCUs), and the shapes of a 5 MP frame's renders."""

import itertools

import numpy as np

KINDS = ("noise", "black", "white", "gradient", "smooth", "primaries")
SIZES = ((1, 1), (8, 8), (9, 9), (17, 23), (31, 47), (40, 40), (192, 256))
QUALITIES = (75, 90)
# (H, W), components, quality, content: every size grey and RGB, and one
# 192x512 RGB image (12 MCU rows of 32, each MCU's chroma past the Y blocks'
# rows on none of them).
CASES = [((h, w), c, q, kind) for (h, w), c, q, kind in itertools.product(SIZES, (1, 3), QUALITIES, KINDS)]
CASES += [((192, 512), 3, q, kind) for q, kind in itertools.product(QUALITIES, KINDS)]
# The renders of a 5 MP frame (2560x1920): the two grey ones, the
# side-by-side and stacked stereo composites.
FRAME_SHAPES = ((1920, 2560), (1920, 5120, 3), (3840, 2560, 3))

# Red, green, blue and their mixes: Cb and Cr at 0 and 255.
PRIMARIES = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255], [255, 255, 0], [0, 255, 255], [255, 0, 255], [0, 0, 0],
                      [255, 255, 255]], np.uint8)


def case_id(case) -> str:
    (h, w), c, q, kind = case
    return f"{h}x{w}-{'rgb' if c == 3 else 'grey'}-q{q}-{kind}"


def image(kind: str, shape, seed: int) -> np.ndarray:
    """A uint8 (H, W) or (H, W, 3) image of the given kind."""
    rng = np.random.default_rng(seed)
    H, W = shape[:2]
    rgb = len(shape) == 3
    if kind == "noise":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    if kind in ("black", "white"):
        return np.full(shape, 0 if kind == "black" else 255, np.uint8)
    yy, xx = np.mgrid[:H, :W]
    if kind == "gradient":
        g = (xx * 255 // max(W - 1, 1) + 3 * yy) % 256
        img = np.stack([g, (7 * g) % 256, 255 - g], axis=-1) if rgb else g
        return img.astype(np.uint8)
    if kind == "smooth":
        base = 128 + 100 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
        img = base[..., None] + np.array([0.0, 30.0, -30.0]) if rgb else base
        return np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)
    if kind == "primaries":
        img = PRIMARIES[(xx // 3 + yy // 2) % len(PRIMARIES)]
        return img if rgb else np.ascontiguousarray(img[..., 0])
    raise ValueError(kind)


def case_image(case) -> tuple:
    """(image, quality) of a CASES entry, seeded by its position."""
    (h, w), c, q, kind = case
    return image(kind, (h, w) if c == 1 else (h, w, 3), CASES.index(case)), q
