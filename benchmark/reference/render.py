"""Reference copy of wass_tpu_torch/utils/render.py (the stereo renders), frozen when the
benchmark was written: plain PyTorch and NumPy, importing nothing of the
program; where the program launches a CUDA kernel this copy runs the
kernel's plain version.  The original's notes follow.

Debug-image rendering (render.hpp and the matcher/stereo debug imagery).

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
JAX package's bit for bit; save() fetches the uint8 image and encodes it
on the host (JPEG, io/image.py).  render_matches rasterises its lines on
the host with numpy, as the JAX function does.  The flow renders
(flow.png, flow_coarse.png; render_flow) are built on the host too, in
float64 numpy, the JAX function's own code on the fetched flow field, and
written losslessly as RGB PNG by the port's writer (save_png).
"""

from __future__ import annotations


import torch

from .frame import (
    FAIL_ANGLE, FAIL_BURNED, FAIL_NO_DISPARITY, FAIL_OUTSIDE_BBOX,
    FAIL_OUTSIDE_IMAGE, FAIL_TOO_CLOSE, FAIL_TOO_DISTANT,
)
from .precision import render_dtype

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
    return q.to(render_dtype()) / 16.0


def _gray3(img: torch.Tensor) -> torch.Tensor:
    return torch.stack([img.to(render_dtype())] * 3, dim=-1)


def render_disparity(disp: torch.Tensor) -> torch.Tensor:
    """Normalized disparity; invalid (<= 0) stays black."""
    d = disp.to(render_dtype())
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
        img = _gray3(torch.clamp(base_gray.to(render_dtype()), 0, 255))
    else:
        img = torch.full(reasons.shape + (3,), 128.0, dtype=render_dtype(), device=dev)
    lut = torch.zeros((256, 3), dtype=render_dtype())
    coloured = torch.zeros(256, dtype=torch.bool)
    for code, rgb in FAIL_COLORS.items():
        lut[code] = torch.tensor(rgb, dtype=render_dtype())
        coloured[code] = True
    r = reasons.long()
    return _u8(torch.where(coloured.to(dev)[r][..., None], lut.to(dev)[r], img))


def render_components(valid: torch.Tensor) -> torch.Tensor:
    """The component/validity map (graph_components.jpg): surviving grid
    points in white."""
    return valid.to(torch.uint8) * 255


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
