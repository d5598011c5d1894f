"""Sea-surface radiance over the elevation grid.

Counterpart of wass_tpu/post/radiance.py (the wasspost radiance family,
wasspost.py:822-1145):

* radiance_frame: a camera image sampled at the projection of every grid
  point (the projection in float64 on the host, the bilinear gather on the
  device with the port's ops/sampling.bilinear_sample);
* bg_radiance: the time-wise box filter of a radiance cube (the bgimage
  command, :1014-1074), scipy on the host;
* vats_threshold and radiance_threshold: background-subtracted
  binarization, optionally with the VATS automatic threshold
  (:1084-1145), on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from wass_tpu_torch.device import resolve_device
from wass_tpu_torch.ops.sampling import bilinear_sample


def project_grid(Z: np.ndarray, XX: np.ndarray, YY: np.ndarray, Pplane: np.ndarray, image_size) -> tuple:
    """float32 image coordinates (mapx, mapy) of the grid points (x, y,
    z(x, y)) through the normalized 4x4 projection Pplane (gridded.nc meta
    P{cam}plane) of an image of image_size (width, height)."""
    Iw, Ih = image_size
    toNorm = np.array([[2.0 / Iw, 0, -1, 0], [0, 2.0 / Ih, -1, 0], [0, 0, 1, 0], [0, 0, 0, 1]], float)
    Pcam = np.linalg.inv(toNorm) @ np.asarray(Pplane, float)
    p2d = Pcam @ np.stack([XX.ravel(), YY.ravel(), Z.ravel(), np.ones(XX.size)])
    mapx = (p2d[0] / p2d[2]).reshape(Z.shape).astype(np.float32)
    mapy = (p2d[1] / p2d[2]).reshape(Z.shape).astype(np.float32)
    return mapx, mapy


def radiance_frame(img: np.ndarray, Z: np.ndarray, XX: np.ndarray, YY: np.ndarray, Pplane: np.ndarray,
                   device="cuda") -> np.ndarray:
    """Grid-texture radiance of one frame in [0, 1]: the image sampled at
    the projection of every grid point."""
    dev = resolve_device(device)
    Ih, Iw = img.shape
    mapx, mapy = project_grid(Z, XX, YY, Pplane, (Iw, Ih))
    out = bilinear_sample(torch.as_tensor(np.asarray(img, np.float32), device=dev),
                          torch.as_tensor(mapx, device=dev), torch.as_tensor(mapy, device=dev))
    return out.cpu().numpy() / 255.0


def bg_radiance(cube: np.ndarray, filtersize: int) -> np.ndarray:
    """Temporal box filter (uniform_filter1d along axis 0, reflect mode)."""
    from scipy.ndimage import uniform_filter1d

    return uniform_filter1d(np.asarray(cube, np.float32), size=filtersize, axis=0, mode="reflect")


def vats_threshold(values: np.ndarray, bins: int = 30) -> float:
    """VATS automatic threshold (wasspost.py:1119-1139): the histogram knee
    at maximum distance from the peak -> tail chord."""
    h, bin_edges = np.histogram(values, bins=bins, density=True)
    xx = np.arange(h.shape[0])
    pts = np.concatenate([xx[None], h[None], np.ones((1, h.shape[0]))])
    peak_idx = int(np.argmax(h))
    chord = np.cross(pts[:, peak_idx], pts[:, -1])
    distances = np.abs(chord @ pts)
    threshold_idx = int(np.argmax(distances[peak_idx:])) + peak_idx
    return float(bin_edges[threshold_idx + 1])


def radiance_threshold(radiance: np.ndarray, bg: np.ndarray, threshold_val: float = 0.35,
                       use_vats: bool = False) -> np.ndarray:
    """Per-frame background-subtracted binarization (:1126-1145)."""
    out = np.zeros(radiance.shape, np.uint8)
    for i in range(radiance.shape[0]):
        Isub = radiance[i] - (bg[i] - np.nanmin(bg[i]))
        t = vats_threshold(Isub) if use_vats else threshold_val
        out[i] = (Isub > t).astype(np.uint8)
    return out
