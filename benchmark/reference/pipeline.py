"""One frame of the reference: what the program's stereo loop writes for a
pair, worked out again from the two 8-bit images, the rig and the settings.

frame() follows the loop's path for one frame (the dispatch's upload,
rectification and dense frame; the writer's fallback re-run at full range
where the c2f guard trips, the MIN_TRIANGULATED_POINTS gate, the plane and
the u16 export with its header), and renders() the writer's six debug
images as the JPEG bytes decode.  The frame takes no input from the
program: the rectification, the AUTO smoothing and every later stage are
computed here.
"""

from __future__ import annotations

import cv2
import numpy as np
import torch

from . import render
from .degradation import resolve_smooth_sigma
from .frame import DenseStereoPipeline, build_geom_pack, export_u16, prepare_frame_geometry, rectify_on_device
from .geometry import rt_from_plane

JPEG_QUALITY = 75  # the program's render quality (Pillow's default)


def smooth_sigma(cfg, first_cam0: np.ndarray) -> float:
    """The AUTO pre-smoothing sigma, resolved from the sequence's first cam0
    image as the loop resolves it once a sequence."""
    return resolve_smooth_sigma(cfg.input_smooth_sigma, first_cam0.astype(np.float32), "dense")


@torch.no_grad()
def frame(img0: np.ndarray, img1: np.ndarray, K0, K1, R, T, cfg, device) -> dict:
    """The reference's outputs of one frame from its uint8 pair: plane (4,)
    float64 (NaN when the fit failed), n_points, the u16 rows (n, 3) with
    their float64 scales, mins, Rinv, Tinv (None where the plane failed),
    and what the renders need."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    H, W = img0.shape
    geom = prepare_frame_geometry(K0, K1, R, T, (W, H), cam_distance=cfg.cam_distance)
    gp = build_geom_pack(geom, (H, W), device)
    b_img, m_img = (img0, img1) if geom.base_is_cam0 else (img1, img0)
    b8, m8 = (torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in (b_img, m_img))
    b, m = b8.to(torch.float32), m8.to(torch.float32)
    base_rect = rectify_on_device(b, gp["H_base"], (H, W))
    match_rect = rectify_on_device(m, gp["H_match"], (H, W))
    pipe = DenseStereoPipeline(cfg)
    res = pipe(base_rect, match_rect, gp)
    out = {"c2f": pipe.last_c2f, "geom": geom, "res": res, "imgs": (b8, m8), "rect": (base_rect, match_rect),
           "n_points": int(res.n_points), "rows": None}
    if out["n_points"] < cfg.min_triangulated:
        out["plane"] = np.full(4, np.nan)
        return out
    plane = res.plane.cpu().numpy().astype(np.float64)
    if not bool(res.plane_ok) or not np.all(np.isfinite(plane)):
        out["plane"] = np.full(4, np.nan)
        return out
    out["plane"] = plane
    plane32 = torch.as_tensor(plane, dtype=torch.float32)
    _Rp, _Tp, Rinv, Tinv = (a.numpy().astype(np.float64) for a in rt_from_plane(plane32))
    q, mins, scales = export_u16(res.points, res.valid, plane32.to(device), out["n_points"])
    out.update(rows=q.cpu().numpy().astype(np.uint16), mins=mins.cpu().numpy().astype(np.float64),
               scales=scales.cpu().numpy().astype(np.float64), Rinv=Rinv, Tinv=Tinv)
    return out


def mesh_cam0(out: dict) -> np.ndarray:
    """The reference's rows decoded to camera-0 points (N, 3), float64, as
    the .xyzC decoder decodes a file."""
    pts = out["rows"].astype(np.float64) / out["scales"][None, :] + out["mins"][None, :]
    return pts @ out["Rinv"].T + out["Tinv"][None, :]


def jpeg_bytes(img: np.ndarray) -> bytes:
    """An image's JPEG file as the program writes it (its encoder settings)."""
    img = np.clip(img, 0, 255).astype(np.uint8)
    if img.ndim == 3:
        img = np.ascontiguousarray(img[..., ::-1])  # RGB -> OpenCV's BGR
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, JPEG_QUALITY])
    if not ok:
        raise ValueError("OpenCV cannot encode a JPEG")
    return buf.tobytes()


def jpeg_roundtrip(img: np.ndarray) -> np.ndarray:
    """An image as its JPEG (the program's encoder settings) decodes."""
    return cv2.imdecode(np.frombuffer(jpeg_bytes(img), np.uint8), cv2.IMREAD_UNCHANGED)


@torch.no_grad()
def render_images(out: dict) -> dict:
    """The six debug renders of a reference frame by file name, as images
    before their JPEG encoding (host arrays)."""
    res = out["res"]
    images = render.stereo_renders(res.disparity, res.valid, res.fail_reasons, out["imgs"], out["rect"],
                                   out["geom"].roi)
    return {name: img.cpu().numpy() for name, img in images.items()}


def renders(out: dict) -> dict:
    """The six debug renders of a reference frame by file name, as decoded
    from their JPEG bytes."""
    return {name: jpeg_roundtrip(img) for name, img in render_images(out).items()}
