"""Debug-image rendering (render.hpp and the matcher/stereo debug imagery).

Counterpart of wass_tpu/utils/render.py: the normalized disparity image
(render_disparity_float, render.hpp:55-87), the stacked or side-by-side
stereo composite with scanlines (:89-173), the disparity coverage over
the rectified base image (wass_stereo.cpp:1006-1025), the triangulation
failure map (:1114-1119, 1378-1383), the component map
(graph_components.jpg, PovMesh.cpp:982-984) and the match plot
(wass_match.cpp:70-95).

Each stereo render builds its uint8 (H, W) or (H, W, 3) image with torch
ops on the device of its inputs, in float64 as the JAX package's numpy
does, with the same clip and truncation to uint8, so the images equal the
JAX package's bit for bit; fetch() copies the uint8 image to the host and
save() encodes it there (JPEG, io/image.py).  render_matches rasterises its lines on
the host with numpy, as the JAX function does.  The flow renders
(flow.png, flow_coarse.png; render_flow) are built on the host too, in
float64 numpy, the JAX function's own code on the fetched flow field, and
written losslessly as RGB PNG by the port's writer (save_png).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from wass_tpu_torch.io import png
from wass_tpu_torch.io.image import encode_jpeg
from wass_tpu_torch.stereo.dense import (
    FAIL_ANGLE, FAIL_BURNED, FAIL_NO_DISPARITY, FAIL_OUTSIDE_BBOX,
    FAIL_OUTSIDE_IMAGE, FAIL_TOO_CLOSE, FAIL_TOO_DISTANT,
)

# The reference's failure colours (BGR cv::Vec3b there), as RGB.
FAIL_COLORS = {
    FAIL_NO_DISPARITY: (0, 0, 0),
    FAIL_OUTSIDE_IMAGE: (0, 255, 255),  # teal
    FAIL_OUTSIDE_BBOX: (255, 255, 0),  # yellow
    FAIL_BURNED: (255, 255, 0),  # the mask colour
    FAIL_ANGLE: (0, 255, 0),  # green
    FAIL_TOO_CLOSE: (0, 0, 255),  # blue
    FAIL_TOO_DISTANT: (255, 0, 0),  # red
}


def _u8(img: torch.Tensor) -> torch.Tensor:
    """numpy's clip(img, 0, 255).astype(uint8): truncation toward zero."""
    return torch.clamp(img, 0, 255).to(torch.uint8)


def to_u8(img: torch.Tensor) -> torch.Tensor:
    """An image as the JAX loop fetches it for the renders (dense.py:_jit_u8;
    XLA converts NaN to 0)."""
    return _u8(torch.nan_to_num(img, nan=0.0))


def disparity_u16(disp: torch.Tensor) -> torch.Tensor:
    """The disparity the JAX loop renders (dense.py:_jit_disp_u16): 1/16-px
    fixed point, clipped to uint16 with truncation, then / 16 in float64."""
    q = torch.clamp(torch.nan_to_num(disp * 16.0, nan=0.0), 0, 65535).to(torch.int32)
    return q.to(torch.float64) / 16.0


def _gray3(img: torch.Tensor) -> torch.Tensor:
    return torch.stack([img.to(torch.float64)] * 3, dim=-1)


def render_disparity(disp: torch.Tensor) -> torch.Tensor:
    """Normalized disparity; invalid (<= 0) stays black."""
    d = disp.to(torch.float64)
    m = d > 0
    lo = torch.where(m, d, torch.inf).amin()
    hi = torch.where(m, d, -torch.inf).amax()
    vis = (d - lo) / torch.clamp_min(hi - lo, 1e-9) * 235 + 20
    return _u8(torch.where(m, vis, 0.0))


def render_stereo(left: torch.Tensor, right: torch.Tensor, vertical: bool = False, n_lines: int = 20) -> torch.Tensor:
    """Stereo composite with red scanlines for rectification checks (the
    stereo.jpg output, wass_stereo.cpp:1910-1926)."""
    comp = _gray3(torch.cat([left, right], dim=0 if vertical else 1))
    steps = max(comp.shape[0] // (n_lines + 1), 1)
    comp[steps::steps, :, 0] = 255
    comp[steps::steps, :, 1:] *= 0.4
    return _u8(comp)


def _index(i: int, n: int) -> int:
    """numpy's bound check of one index (a CUDA gather would not raise)."""
    if not -n <= i < n:
        raise IndexError(f"index {i} is out of bounds for size {n}")
    return i % n


def render_coverage(img: torch.Tensor, disp: torch.Tensor, roi=None) -> torch.Tensor:
    """Green-tint disparity coverage over the rectified base image, the ROI
    outlined in red (disparity_coverage.jpg, wass_stereo.cpp:1006-1025)."""
    vis = _gray3(img)
    vis[..., 1] = torch.where(disp > 1, torch.clamp_min(vis[..., 1], 100), vis[..., 1])
    if roi is not None:
        x, y, w, h = (int(v) for v in roi)
        H, W = vis.shape[:2]
        for col in (x, min(x + w - 1, W - 1)):
            vis[y:y + h, _index(col, W), 0] = 255
        for row in (y, min(y + h - 1, H - 1)):
            vis[_index(row, H), x:x + w, 0] = 255
    return _u8(vis)


def render_failure_map(reasons: torch.Tensor, base_gray=None) -> torch.Tensor:
    """Colour-coded triangulation failure map (the reference's dbg_R0/R1
    imagery): triangulated pixels show the grey image (or mid-grey), the
    failures their FAIL_COLORS."""
    dev = reasons.device
    if base_gray is not None:
        img = _gray3(torch.clamp(base_gray.to(torch.float64), 0, 255))
    else:
        img = torch.full(reasons.shape + (3,), 128.0, dtype=torch.float64, device=dev)
    lut = torch.zeros((256, 3), dtype=torch.float64)
    coloured = torch.zeros(256, dtype=torch.bool)
    for code, rgb in FAIL_COLORS.items():
        lut[code] = torch.tensor(rgb, dtype=torch.float64)
        coloured[code] = True
    r = reasons.long()
    return _u8(torch.where(coloured.to(dev)[r][..., None], lut.to(dev)[r], img))


def render_components(valid: torch.Tensor) -> torch.Tensor:
    """The component/validity map (graph_components.jpg): surviving grid
    points in white."""
    return valid.to(torch.uint8) * 255


def render_matches(img0: np.ndarray, img1: np.ndarray, uv0: np.ndarray, uv1: np.ndarray) -> np.ndarray:
    """Side-by-side match plot (render_matches, wass_match.cpp:70-95), drawn
    with numpy line rasterization on the host."""
    L = np.asarray(img0, np.float64)
    R = np.asarray(img1, np.float64)
    comp = np.concatenate([L, R], axis=1)
    comp = np.stack([comp] * 3, axis=-1)
    W0 = L.shape[1]
    for (x0, y0), (x1, y1) in zip(np.asarray(uv0), np.asarray(uv1)):
        x1s = x1 + W0
        n = int(max(abs(x1s - x0), abs(y1 - y0), 1))
        xs = np.linspace(x0, x1s, n).astype(int)
        ys = np.linspace(y0, y1, n).astype(int)
        ok = (xs >= 0) & (xs < comp.shape[1]) & (ys >= 0) & (ys < comp.shape[0])
        comp[ys[ok], xs[ok]] = [255, 255, 0]
    return np.clip(comp, 0, 255).astype(np.uint8)


def stereo_renders(disparity: torch.Tensor, valid: torch.Tensor, fail_reasons, imgs, rect, roi) -> dict:
    """A stereo frame's debug renders by file name, as the JAX loop makes
    them (wass_tpu/cli/pipeline.py:_finalize_stereo_frame): from the
    1/16-px disparity, the uploaded uint8 base and match images (imgs), the
    rectified pair (rect, taken to uint8), the valid mask and the failure
    codes."""
    disp = disparity_u16(disparity)
    base_u8, match_u8 = (to_u8(t) for t in rect)
    images = {
        "stereo_input.jpg": render_stereo(*imgs, vertical=True),
        "disparity_final_scaled.jpg": render_disparity(disp),
        "stereo.jpg": render_stereo(base_u8, match_u8),
        "disparity_coverage.jpg": render_coverage(base_u8, disp, roi=roi),
        "graph_components.jpg": render_components(valid),
    }
    if fail_reasons is not None:
        images["triangulation_failmap.jpg"] = render_failure_map(fail_reasons, base_u8)
    return images


def fetch(img) -> np.ndarray:
    """A render's uint8 image (tensor or array) on the host: a tensor's
    copy waits for the device work that builds it."""
    return img.cpu().numpy() if isinstance(img, torch.Tensor) else img


def save(path, img) -> None:
    """Fetch a render's uint8 image (tensor or array) and write it as JPEG."""
    Path(path).write_bytes(encode_jpeg(fetch(img)))


def _flow_color_wheel() -> np.ndarray:
    """Middlebury flow colour wheel (drawOpticalFlow,
    wass_stereo.cpp:1398-1466): 55 hue steps with perceptually chosen
    transition lengths."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    cols = []
    for i in range(RY):
        cols.append((255, 255 * i // RY, 0))
    for i in range(YG):
        cols.append((255 - 255 * i // YG, 255, 0))
    for i in range(GC):
        cols.append((0, 255, 255 * i // GC))
    for i in range(CB):
        cols.append((0, 255 - 255 * i // CB, 255))
    for i in range(BM):
        cols.append((255 * i // BM, 0, 255))
    for i in range(MR):
        cols.append((255, 0, 255 - 255 * i // MR))
    return np.array(cols, np.float32)


def render_flow(flow, max_motion: float = -1.0) -> np.ndarray:
    """Flow-field visualization with the Middlebury colour coding
    (saturation encodes magnitude, hue direction): the (H, W, 3) uint8 RGB
    image of the JAX function, from an (H, W, 2) flow (tensor or array)."""
    if isinstance(flow, torch.Tensor):
        flow = flow.cpu().numpy()
    fx = flow[..., 0]
    fy = flow[..., 1]
    ok = np.isfinite(fx) & np.isfinite(fy) & (np.abs(fx) < 1e9) & (np.abs(fy) < 1e9)
    rad = np.sqrt(fx * fx + fy * fy)
    maxrad = max_motion if max_motion > 0 else max(1.0, np.nanmax(np.where(ok, rad, 0)))
    fx = np.where(ok, fx / maxrad, 0)
    fy = np.where(ok, fy / maxrad, 0)
    rad = np.sqrt(fx * fx + fy * fy)

    wheel = _flow_color_wheel()
    ncols = len(wheel)
    a = np.arctan2(-fy, -fx) / np.pi
    fk = (a + 1.0) / 2.0 * (ncols - 1)
    k0 = np.floor(fk).astype(int) % ncols
    k1 = (k0 + 1) % ncols
    f = (fk - np.floor(fk))[..., None]
    col = (wheel[k0] * (1 - f) + wheel[k1] * f) / 255.0
    small = rad <= 1
    col = np.where(small[..., None], 1 - rad[..., None] * (1 - col), col * 0.75)
    img = np.where(ok[..., None], col * 255.0, 0.0)
    return np.clip(img, 0, 255).astype(np.uint8)


def save_png(path, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB render as PNG (lossless)."""
    Path(path).write_bytes(png.encode_rgb(img))
