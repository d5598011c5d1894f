"""Polarimetric (PFA camera) processing: demosaic -> Stokes -> HDR / DoLP / AoLP.

Counterpart of wass_tpu/prepare/polar.py, the math of process_image
(wass_prepare.cpp:103-255 of the WASS sources):

* 2x2 superpixel demosaic (:52-85): I90 = I[0::2, 0::2], I45 = I[0::2, 1::2],
  I0 = I[1::2, 1::2], I135 = I[1::2, 0::2];
* each channel is upscaled 2x (bilinear) and undistorted;
* polarization consistency filter with k1 = 0.75, k2 = 0.25 enforcing
  I0 + I90 = I45 + I135 (:141-154);
* Stokes: S0 = (I0+I45+I90+I135)/2, S1 = I0-I90, S2 = I45-I135;
* HDR fusion with Gaussian well-exposedness weights, sigma = 0.3
  (:197-208), else intensity = S0 * 127;
* DoLP = sqrt(S1^2+S2^2)/S0, AoLP = (atan2(S1, S2) - pi)/2 (:234-249).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from wass_tpu_torch.ops.sampling import resize, undistort_image


def demosaic(img: torch.Tensor):
    """(H, W) -> 4 channels (H/2, W/2): I0, I45, I90, I135."""
    I90 = img[0::2, 0::2]
    I45 = img[0::2, 1::2]
    I0 = img[1::2, 1::2]
    I135 = img[1::2, 0::2]
    return I0, I45, I90, I135


class PolarResult(NamedTuple):
    intensity: torch.Tensor  # 8-bit-range image for the stereo pipeline
    S0: torch.Tensor
    S1: torch.Tensor
    S2: torch.Tensor
    dolp: torch.Tensor
    aolp: torch.Tensor
    I0: torch.Tensor
    I45: torch.Tensor
    I90: torch.Tensor
    I135: torch.Tensor


def polarimetric_process(
    img: torch.Tensor,
    K: Optional[torch.Tensor] = None,
    dist: Optional[torch.Tensor] = None,
    use_hdr: bool = True,
) -> PolarResult:
    """The polarimetric path of a raw PFA frame (uint8-range floats)."""
    chans = [c.to(torch.float32) / 255.0 for c in demosaic(img)]

    # Upscale 2x + undistort each channel (:132-144).
    H2, W2 = img.shape
    out = []
    for c in chans:
        up = resize(c, (H2, W2), interp="linear")
        if K is not None and dist is not None:
            up = undistort_image(up, K, dist)
        out.append(up)
    I0o, I45o, I90o, I135o = out

    # Consistency filter (:141-154).
    k1, k2 = 0.75, 0.25
    I0f = k1 * I0o + k2 * I45o - k2 * I90o + k2 * I135o
    I45f = k2 * I0o + k1 * I45o + k2 * I90o - k2 * I135o
    I90f = -k2 * I0o + k2 * I45o + k1 * I90o + k2 * I135o
    I135f = k2 * I0o - k2 * I45o + k2 * I90o + k1 * I135o

    S0 = (I0f + I45f + I90f + I135f) * 0.5
    S1 = I0f - I90f
    S2 = I45f - I135f

    if use_hdr:
        sig = 0.3
        ws = [torch.exp(-((c - 0.5) ** 2) / (2 * sig * sig)) for c in (I0f, I45f, I90f, I135f)]
        num = ws[0] * I0f + ws[1] * I45f + ws[2] * I90f + ws[3] * I135f
        den = ws[0] + ws[1] + ws[2] + ws[3]
        intensity = torch.clamp(num / torch.clamp_min(den, 1e-12) * 255.0, 0, 255)
    else:
        intensity = torch.clamp(S0 * 127.0, 0, 255)

    dolp = torch.sqrt(S1 * S1 + S2 * S2) / torch.clamp_min(S0, 1e-12)
    ang = torch.atan2(S1, S2)
    ang = torch.where(ang < 0, ang + 2 * math.pi, ang)  # cartToPolar returns [0, 2pi)
    aolp = (ang - math.pi) * 0.5

    return PolarResult(
        intensity=intensity, S0=S0, S1=S1, S2=S2, dolp=dolp, aolp=aolp,
        I0=I0f, I45=I45f, I90=I90f, I135=I135f,
    )
