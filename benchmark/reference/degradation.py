"""Reference copy of wass_tpu_torch/prepare/degradation.py, frozen when the
benchmark was written: plain PyTorch and NumPy, importing nothing of the
program; where the program launches a CUDA kernel this copy runs the
kernel's plain version.  The original's notes follow.

Input degradation estimation -> automatic pre-smoothing selection.

Copied from wass_tpu/prepare/degradation.py (numpy only), whose package
__init__ imports jax.  See that module for the measurements behind the
thresholds and sigmas.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class DegradationEstimate(NamedTuple):
    noise_sigma: float  # estimated additive-Gaussian sensor noise (gray levels)
    blockiness: float  # 8-periodic boundary-gradient ratio (1.0 = none)


def _center_crop(img: np.ndarray, max_side: int = 1024) -> np.ndarray:
    H, W = img.shape
    ch, cw = min(H, max_side), min(W, max_side)
    y0 = ((H - ch) // 2) // 8 * 8
    x0 = ((W - cw) // 2) // 8 * 8
    return img[y0 : y0 + ch, x0 : x0 + cw]


def _noise_sigma(img: np.ndarray) -> float:
    """Median-robust Immerkaer noise estimate.

    The Laplacian-difference mask [[1,-2,1],[-2,4,-2],[1,-2,1]] removes
    locally-linear image structure; on N(0, s) noise its response has
    std 6s, so s = median|r| / (0.6745 * 6).  The median (vs Immerkaer's
    mean) ignores the sparse large responses of true edges/texture.
    """
    i = img.astype(np.float64)
    r = (
        i[:-2, :-2] - 2 * i[:-2, 1:-1] + i[:-2, 2:]
        - 2 * i[1:-1, :-2] + 4 * i[1:-1, 1:-1] - 2 * i[1:-1, 2:]
        + i[2:, :-2] - 2 * i[2:, 1:-1] + i[2:, 2:]
    )
    return float(np.median(np.abs(r)) / (0.6745 * 6.0))


def _blockiness(img: np.ndarray) -> float:
    """Phase-maximal 8-periodic boundary-gradient ratio, max over axes."""
    i = img.astype(np.float64)
    out = 1.0
    for ax in (0, 1):
        d = np.abs(np.diff(i, axis=ax))
        n = d.shape[ax]
        means = np.array(
            [d.take(range(p, n, 8), axis=ax).mean() for p in range(8)]
        )
        best = float(means.max())
        rest = float(means.sum() - best) / 7.0
        out = max(out, best / max(rest, 1e-9))
    return out


def estimate_degradation(img: np.ndarray, max_side: int = 1024) -> DegradationEstimate:
    """Estimate (noise sigma, JPEG blockiness) from one grayscale image."""
    c = _center_crop(np.asarray(img), max_side)
    return DegradationEstimate(_noise_sigma(c), _blockiness(c))


# Decision thresholds, placed in the measured gaps between classes
# (probe values above): noise fires between quantization-level jitter
# (<= 0.25 on clean/JPEG) and real sensor noise (>= 1.0 at sigma=1);
# blockiness fires between q95 (1.67) and q93/q90 (1.87/2.15).
NOISE_HEAVY = 4.5  # sigma >= ~5: heavy sensor noise
NOISE_ON = 1.2  # sigma >= ~1.5: moderate sensor noise
BLOCKY_ON = 1.85  # JPEG q <= ~93

# Sigmas quantized to the measured-passing set (a small discrete set
# also bounds jit recompiles: the smoothing sigma is a static argument
# of the census/detector programs).  noise_heavy carries an additional
# ACTION for the matcher: match_frame downsamples the pair 2x (block
# mean) and applies the clean sigma there — the only measured-passing
# configuration at sigma=8 (ROBUSTNESS_r05 noise_s8_sweep + half-res
# probe: pooled dR 2.0e-3 / dT 1.7e-2).
_MATCH_SIGMA = {"clean": 0.8, "noise": 1.5, "noise_heavy": 0.8, "jpeg": 2.5}
_DENSE_SIGMA = {"clean": 0.8, "noise": 1.5, "noise_heavy": 1.5, "jpeg": 0.8}


def classify(est: DegradationEstimate) -> str:
    """Degradation class.  Noise is tested first: JPEG re-compression of
    noisy input *suppresses* the noise estimate (the DCT quantization
    low-passes it), so a high noise reading means noise genuinely
    dominates, while deep-JPEG inputs read noise <= 0.25."""
    if est.noise_sigma >= NOISE_HEAVY:
        return "noise_heavy"
    if est.noise_sigma >= NOISE_ON:
        return "noise"
    if est.blockiness >= BLOCKY_ON:
        return "jpeg"
    return "clean"


def auto_smooth_sigma(est: DegradationEstimate, stage: str = "match") -> float:
    """Measured-passing pre-smoothing sigma for the estimated degradation.

    match:  clean/q95 -> 0.8 (pooled-pose gates PASS; more smoothing
            degrades the clean dT gate), sensor noise -> 1.5 (rescues
            sigma=3: pooled 2.1e-2/3.7e-2 -> 3.0e-3/3.4e-3), deep JPEG
            -> 2.5 (rescues q90 to 4.8e-4/1.4e-3 and q70 to
            1.3e-3/1.5e-2).  All numbers: ROBUSTNESS_r04/r05.
    dense:  0.8 baseline (q95 elevation 0.0205 -> 0.0170, inside the
            0.02 gate, at ~2% clean cost); sensor noise -> 1.5 (best
            measured, 0.0795 -> 0.0579).
    """
    table = _MATCH_SIGMA if stage == "match" else _DENSE_SIGMA
    return table[classify(est)]


def resolve_smooth_sigma(
    cfg_sigma: float, img: np.ndarray, stage: str = "match"
) -> float:
    """Resolve a config sigma: negative means AUTO (estimate from img)."""
    if cfg_sigma >= 0:
        return float(cfg_sigma)
    return auto_smooth_sigma(estimate_degradation(img), stage)
